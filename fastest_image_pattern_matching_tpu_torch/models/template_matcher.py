"""Coarse-to-fine rotation-invariant NCC template matching in PyTorch — the
port of fastest_image_pattern_matching_tpu/models/template_matcher.py,
itself the equivalent of the reference's Match() pipeline
(MatchTool/MatchToolDlg.cpp:772-1148) and LearnPattern (:453-491).

  * learn_pattern: host-side float64 stats, pyramid through the same
    pyr_down as the source (bit-identical levels).
  * match: pyramid build, batched top-layer angle sweep (one batched warp
    and one correlation per chunk of angles), greedy peak extraction,
    candidate descent in chunks of alive candidates, batched subpixel
    solve, rotated-rect NMS. The stages run eagerly on the given device;
    shapes follow the same static plan as the JAX package. On a CUDA
    device every warp goes through the hand-written warp kernel, and every
    large score map with a small template (the tol=0 many-target sweep)
    through the hand-written correlation kernel.
  * match_candidates: the top-layer candidate dump; match_template: the
    no-pyramid score map.

Sorting follows the JAX package's tie rules exactly: stable sorts where JAX
uses top_k (lower index first) or argsort(stable), chained stable sorts in
the same key order where it uses lexsort, first-max argmax.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import D2R, MATCH_CANDIDATE_NUM, MatchConfig, R2D, VISION_TOLERANCE
from ..types import LearnedPattern, LevelData, MatchResult
from ..utils import geometry
from ..utils.chunking import chunked_map
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..ops.pyramid import build_pyramid
from ..ops.ncc import (descent_best, descent_best_stack, ncc_score_map,
                       ncc_score_stack, score_constants)
from ..ops.peaks import extract_peaks
from ..ops.nms import filter_overlaps, rotated_rect_corners
from ..ops.subpixel import subpixel_refine
from ..ops.rounding import f32
from ..ops.warp import make_rotation_invmaps, rotate_pt, warp_affine_dispatch

DBL_EPSILON = 2.220446049250313e-16

# Device-memory budget per chunked stage, in f32 elements (the JAX
# package's value, kept so that both cut the work into the same chunks).
_CHUNK_BUDGET_ELEMS = 128 * 1024 * 1024

# The span of each descent level, named once (a span site builds no
# string).
_LEVEL_SPANS = tuple(f"fipm.descent.L{l}" for l in range(32))


def _descend_chunk(roi_hw, templ_px: int, k_ang: int) -> int:
    """Candidate-chunk size for one descent layer: small chunks on
    expensive layers, so that skipping dead chunks saves real work."""
    chunk = max(1, _CHUNK_BUDGET_ELEMS // (roi_hw[0] * roi_hw[1] * k_ang * 8))
    if templ_px > 4096:
        return min(chunk, 8)
    if templ_px > 1024:
        return min(chunk, 32)
    return min(chunk, 64)


def _sort_desc(key: torch.Tensor) -> torch.Tensor:
    """Indices that sort key descending, ties in index order (the order of
    jax.lax.top_k and of jnp.argsort(-key, stable=True))."""
    return torch.sort(key, descending=True, stable=True).indices


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort along the last axis: the LAST key is primary. Chained
    stable ascending sorts, from the least significant key to the most."""
    order = None
    for k in keys:
        kk = k if order is None else k.gather(-1, order)
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order.gather(-1, o)
    return order


def _pick(keep, score_s, pt_s, ang_s, overflow, max_pos: int, templ_hw):
    """finalize's last step: the NMS survivors [N, C] (score-sorted rows)
    cut to each frame's top max_pos, as results at level-0 size."""
    svals2 = torch.where(keep, score_s, -1.0)
    if svals2.shape[1] < max_pos:  # narrowed below max_pos
        pad = max_pos - svals2.shape[1]
        svals2 = torch.nn.functional.pad(svals2, (0, pad), value=-1.0)
        pt_s = torch.nn.functional.pad(pt_s, (0, 0, 0, pad))
        ang_s = torch.nn.functional.pad(ang_s, (0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
    ord2 = _sort_desc(svals2)[:, :max_pos]
    r_score = _rows(svals2, ord2)
    r_pt = _rows(pt_s, ord2)
    r_ang = _rows(ang_s, ord2)
    r_ok = _rows(keep, ord2) & (r_score >= 0)

    # Result assembly (MatchToolDlg.cpp:1082-1099): level-0 dims, angle
    # negation + wrap to (-180, 180].
    H0, W0 = templ_hw
    corners = rotated_rect_corners(r_pt, r_ang, float(W0), float(H0))
    center = torch.mean(corners, dim=-2)
    out_ang = -r_ang
    out_ang = torch.where(out_ang < -180.0, out_ang + 360.0, out_ang)
    out_ang = torch.where(out_ang > 180.0, out_ang - 360.0, out_ang)
    return dict(score=r_score, angle=out_ang, corners=corners,
                center=center, valid=r_ok, nms_overflow=overflow)


def learn_pattern(templ, min_reduce_area: int = 256,
                  roi: Optional[Tuple[int, int, int, int]] = None,
                  regions=None, device=None) -> LearnedPattern:
    """Build the template pyramid and per-level stats (LearnPattern,
    MatchToolDlg.cpp:453-491). Stats in float64 on the host; the pyramid is
    built on `device` with the source's pyr_down.

    roi: optional (x, y, w, h) sub-rectangle of `templ` to learn from;
    match coordinates then refer to the ROI rectangle.
    regions: optional iterable of [N, 2] polygons in `templ` coordinates,
    projected into every match's source frame by match()."""
    dev = resolve_device(device)
    templ = np.asarray(templ)
    if templ.ndim == 3:
        from ..utils.imageio import ensure_gray
        templ = ensure_gray(templ)
    templ = templ.astype(np.float32)
    if roi is not None:
        x, y, w, h = (int(v) for v in roi)
        if not (0 <= x and 0 <= y and w > 0 and h > 0
                and x + w <= templ.shape[1] and y + h <= templ.shape[0]):
            raise ValueError(f"roi {roi} out of bounds for template "
                             f"{templ.shape}")
        templ = templ[y:y + h, x:x + w]
        roi = (x, y, w, h)
    region_arrs = []
    for reg in (regions or ()):
        pts = np.asarray(reg, np.float32).reshape(-1, 2)
        if pts.shape[0] < 3:
            raise ValueError("each region needs >= 3 points "
                             "(finishPolygonSelection requires 3)")
        if roi is not None:
            pts = pts - np.array([roi[0], roi[1]], np.float32)
        region_arrs.append(pts)

    top = geometry.top_layer(templ.shape, min_reduce_area)
    pyr = [p.cpu().numpy() for p in
           build_pyramid(torch.as_tensor(templ, device=dev), top)]

    levels: List[LevelData] = []
    for p in pyr:
        area = p.shape[0] * p.shape[1]
        mean = float(np.mean(p, dtype=np.float64))
        var = float(np.mean((p.astype(np.float64) - mean) ** 2))
        norm = np.sqrt(var) * np.sqrt(float(area))
        levels.append(LevelData(templ=p, mean=mean, norm=float(norm),
                                inv_area=1.0 / float(area),
                                result_equal1=var < DBL_EPSILON))
    border_color = 255 if float(np.mean(pyr[0], dtype=np.float64)) < 128 else 0
    return LearnedPattern(levels=levels, border_color=border_color,
                          min_reduce_area=min_reduce_area, roi=roi,
                          regions=tuple(region_arrs))


def pattern_from_reference(p) -> LearnedPattern:
    """The port's LearnedPattern from any object shaped like the JAX
    package's (duck-typed: levels[i].templ/.mean/.norm/.inv_area/
    .result_equal1, border_color, min_reduce_area, roi, regions), so that
    both matchers can run on the very same pattern."""
    levels = [LevelData(templ=np.asarray(lv.templ, np.float32),
                        mean=float(lv.mean), norm=float(lv.norm),
                        inv_area=float(lv.inv_area),
                        result_equal1=bool(lv.result_equal1))
              for lv in p.levels]
    roi = None if p.roi is None else tuple(int(v) for v in p.roi)
    return LearnedPattern(
        levels=levels, border_color=int(p.border_color),
        min_reduce_area=int(p.min_reduce_area), roi=roi,
        regions=tuple(np.asarray(r, np.float32) for r in p.regions))


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Static match plan — everything shape-determining, host-computed."""
    src_hw: Tuple[int, int]
    templ_shapes: Tuple[Tuple[int, int], ...]
    top: int
    stop: int
    angles: Tuple[float, ...]
    canvas_hw: Tuple[int, int]
    k_peaks: int
    c_max: int
    nms_cap: int
    k_ang: int
    layer_scores: Tuple[float, ...]
    border_color: int
    cfg: MatchConfig


def _make_plan(src_hw, pattern: LearnedPattern, cfg: MatchConfig) -> _Plan:
    top = pattern.top_layer
    shapes = tuple(tuple(s) for s in pattern.shapes)
    top_hw = shapes[top]
    angles = tuple(geometry.angle_schedule(
        top_hw, cfg.tolerance_angle, cfg.tolerance_ranges))
    src_top_hw = geometry.pyramid_sizes(src_hw, top)[top]
    src_top_wh = (src_top_hw[1], src_top_hw[0])
    templ_top_wh = (top_hw[1], top_hw[0])
    best = [geometry.best_rotation_size(src_top_wh, templ_top_wh, a)
            for a in angles]
    canvas_w = max(max(b[0] for b in best), templ_top_wh[0])
    canvas_h = max(max(b[1] for b in best), templ_top_wh[1])

    layer_scores = [cfg.score]
    for _ in range(top):
        layer_scores.append(layer_scores[-1] * 0.9)

    k_peaks = cfg.max_pos + MATCH_CANDIDATE_NUM
    c_max = min(cfg.effective_max_candidates, len(angles) * k_peaks)
    # NMS column cap: exact whenever the above-threshold candidates fit;
    # finalize flags an overflow and _finalized finalizes again uncapped.
    nms_cap = min(c_max, max(4 * cfg.max_pos + 64, 128))
    single_angle = (cfg.tolerance_ranges is None
                    and cfg.tolerance_angle < VISION_TOLERANCE)
    return _Plan(
        src_hw=tuple(src_hw), templ_shapes=shapes, top=top,
        stop=1 if cfg.fast_mode else 0, angles=angles,
        canvas_hw=(canvas_h, canvas_w), k_peaks=k_peaks, c_max=c_max,
        nms_cap=nms_cap, k_ang=1 if single_angle else 3,
        layer_scores=tuple(layer_scores), border_color=pattern.border_color,
        cfg=cfg)


def _top_sweep_arrays(plan: _Plan):
    """Host-computed per-angle constants: inverse warp maps, translations,
    valid score-map extents, angles (numpy)."""
    sh, sw = geometry.pyramid_sizes(plan.src_hw, plan.top)[plan.top]
    cx, cy = (sw - 1) / 2.0, (sh - 1) / 2.0
    th, tw = plan.templ_shapes[plan.top]
    inv_mats, trans, valid_wh = [], [], []
    for a in plan.angles:
        bw, bh = geometry.best_rotation_size((sw, sh), (tw, th), a)
        t = ((bw - 1) / 2.0 - cx, (bh - 1) / 2.0 - cy)
        m = geometry.rotation_matrix((cx, cy), a)
        m[0, 2] += t[0]
        m[1, 2] += t[1]
        inv_mats.append(geometry.invert_affine(m))
        trans.append(t)
        valid_wh.append((bw, bh))
    return (np.array(inv_mats, np.float32), np.array(trans, np.float32),
            np.array(valid_wh, np.int32), np.array(plan.angles, np.float32))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C, ...] taken at idx [N, k] along each row -> [N, k, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _by_frame(fidx: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Indices [N, M / N] that group flat candidates by frame, each frame's
    in their flat order (every frame holds the same number)."""
    if n_frames == 1:
        return torch.arange(fidx.shape[0], device=fidx.device)[None]
    return torch.sort(fidx, stable=True).indices.reshape(n_frames, -1)


def narrow_bound(max_pos: int) -> int:
    """How many candidates a frame keeps under cfg.narrow_candidates."""
    return max(2 * max_pos + 4, 16)


def narrowed(cands, n_frames: int, cl: int) -> torch.Tensor:
    """Indices [N * cl] into the flat candidates (ptLT, ang, score, alive,
    fidx) of each frame's top cl, dead ones last, ties broken by (score
    desc, y, x, angle): the finalize order."""
    grp = _by_frame(cands[4], n_frames)
    p, a, s, al = (x[grp] for x in cands[:4])
    key = torch.where(al, s, -2.0)
    o = _lexsort((a, p[..., 0], p[..., 1], -key))[:, :cl]
    return _rows(grp, o).reshape(-1)


@dataclasses.dataclass(frozen=True)
class StackLevel:
    """One pyramid level's stats of a stack of G templates of one size
    (a plan group of models/batch.py::_match_group): each template's six
    epilogue constants (ops/ncc.py::score_constants) as a [G, 6] f32 table
    on the device, and what the stack shares: whether the level is flat
    (result_equal1; a plan group holds templates alike in that) and
    whether every template is u8-valued (the descent-score kernel's
    integer route)."""
    consts: torch.Tensor
    result_equal1: bool
    u8_valued: bool


def _prep_src(src: torch.Tensor, cfg: MatchConfig) -> torch.Tensor:
    """Input normalisation: u8-contract clip and bitwise-not. The JAX
    package clips the source to [0, 255] when its correlation runs in
    int8; the same inputs are clipped here so results agree on
    out-of-contract device input as well."""
    if cfg.compute_dtype == "bf16" and cfg.quantize_warp:
        src = torch.clamp(src, 0.0, 255.0)
    if cfg.bitwise_not:
        src = 255.0 - src
    return src


def build_stages(plan: _Plan, stats, device, narrow_hook=None):
    """The pipeline stage functions for a static plan on `device`.

    Frames are the leading axis of every stage: the source pyramid holds
    levels [N, H_l, W_l], the sweep works on N*A canvases, the descent on
    N*C candidates, each carrying its frame index, and finalize returns
    [N, ...] results. One frame is the case N = 1.

    stats: per level (mean, norm, inv_area, result_equal1, u8_valued) as
    Python values. Returns a namespace of the stage functions; _run composes
    them.

    A stack of G templates of one size against one frame (stats: a
    StackLevel per level, templates [G, h_l, w_l]) runs the same stages
    with the template as the row axis where the frame was: G score maps a
    canvas and one peak launch for all, G rows of candidates, each
    carrying its template's row as its frame index does, one descent over
    all of them (a chunk's ROIs each scored against their own template,
    one descent-score launch on the card), and finalize over the G rows.
    Every row samples the one frame.

    narrow_hook: optional fn(ptLT, ang, score, alive, fidx) -> alive, used
    by the sharded matcher (parallel/matcher.py), whose ranks each hold a
    part of every frame's candidates: with cfg.narrow_candidates it keeps
    each frame's global top scorers by masking `alive` (a collective)
    instead of cutting the local candidates, so shapes stay equal on every
    rank and the kept set is the unsharded one."""
    dev = torch.device(device)
    cfg = plan.cfg
    stacked = isinstance(stats[0], StackLevel)
    # Candidate rows a frame: the stack's templates, or the frame alone.
    n_templ = stats[0].consts.shape[0] if stacked else 1
    thr = torch.tensor(plan.layer_scores, dtype=torch.float32, device=dev)
    top, stop = plan.top, plan.stop
    th_t, tw_t = plan.templ_shapes[top]
    Hc, Wc = plan.canvas_hw
    K = plan.k_peaks
    C = plan.c_max
    k_ang = plan.k_ang
    src_sizes = geometry.pyramid_sizes(plan.src_hw, top)
    identity_sweep = (len(plan.angles) == 1 and plan.angles[0] == 0.0)
    sweep_chunk = max(1, _CHUNK_BUDGET_ELEMS // (Hc * Wc * 4 * n_templ))

    def sweep_bounds(n_maps):
        return [(lo, min(n_maps, lo + sweep_chunk))
                for lo in range(0, n_maps, sweep_chunk)]

    def sweep_canvas(src_top, inv_m, fidx):
        """The canvases of maps inv_m [m, 2, 3], map i on frame fidx[i]."""
        if identity_sweep:
            # tol=0: the rotation canvas is the frame itself.
            return torch.nn.functional.pad(
                src_top[fidx], (0, Wc - src_top.shape[-1],
                                0, Hc - src_top.shape[-2]),
                value=float(plan.border_color))
        return warp_affine_dispatch(
            src_top, inv_m, (Hc, Wc), float(plan.border_color),
            quantize=cfg.quantize_warp, src_index=fidx)

    def sweep_layout(n_frames, inv_mats):
        """The N*A canvases, frame-major: their maps and frames."""
        A = inv_mats.shape[0]
        return (inv_mats.repeat(n_frames, 1, 1),
                torch.arange(n_frames * A, device=dev) // A)

    def sweep_maps(src_top, templ_top, inv_mats, valid_wh):
        """Per-canvas score-map peaks: frames [N, H, W], maps [A, 2, 3],
        [A, 2] -> vals [N, A, K], locs [N, A, K, 2] (a stack: one frame,
        [G, A, K] and [G, A, K, 2]). One warp launch per chunk of the N*A
        canvases (map i on frame i // A), one score map a canvas and
        template, and one peak extraction (K rounds) for the chunk."""
        with span("fipm.sweep"):
            lv = stats[top]
            N, A = src_top.shape[0], inv_mats.shape[0]
            Ho, Wo = Hc - th_t + 1, Wc - tw_t + 1
            xs = torch.arange(Wo, dtype=torch.int32,
                              device=dev)[None, None, :]
            ys = torch.arange(Ho, dtype=torch.int32,
                              device=dev)[None, :, None]
            maps, fidx = sweep_layout(N, inv_mats)
            vwhs = valid_wh.repeat(N, 1)
            vals, locs = [], []
            for lo, hi in sweep_bounds(N * A):
                with span("fipm.sweep.chunk"):
                    canv = sweep_canvas(src_top, maps[lo:hi], fidx[lo:hi])
                    vwh = vwhs[lo:hi]
                    ok = ((xs <= (vwh[:, 0] - tw_t)[:, None, None])
                          & (ys <= (vwh[:, 1] - th_t)[:, None, None]))
                    if stacked:  # [m, G, Ho, Wo]: G maps a canvas
                        smap = ncc_score_stack(canv, templ_top, lv.consts,
                                               lv.result_equal1)
                        smap = torch.where(ok[:, None], smap, -1.0
                                           ).reshape(-1, Ho, Wo)
                    else:
                        smap = ncc_score_map(canv, templ_top, *lv[:4])
                        smap = torch.where(ok, smap, -1.0)
                    v, l = extract_peaks(smap, K, (tw_t, th_t),
                                         cfg.max_overlap)
                vals.append(v)
                locs.append(l)
            vals, locs = torch.cat(vals), torch.cat(locs)
            if stacked:  # the canvas-major maps as a row a template
                return (vals.reshape(A, n_templ, K).transpose(0, 1),
                        locs.reshape(A, n_templ, K, 2).transpose(0, 1))
            return vals.reshape(N, A, K), locs.reshape(N, A, K, 2)

    def select_candidates(vals, locs, trans, angles_arr):
        """Per frame: flatten the per-angle peaks, threshold, top-C (the
        reference sorts all candidates by score, MatchToolDlg.cpp:890).
        [N, A, K] -> pt [N, C, 2], ang, score, alive [N, C]."""
        with span("fipm.select"):
            N, n_ang = vals.shape[:2]
            vals_f = vals.reshape(N, n_ang * K)
            locs_f = locs.reshape(N, n_ang * K, 2)
            masked = torch.where(vals_f >= thr[top], vals_f, -1.0)
            top_idx = _sort_desc(masked)[:, :C]
            top_vals = _rows(masked, top_idx)
            aidx = top_idx // K
            pt = _rows(locs_f, top_idx).to(torch.float32) - trans[aidx]
            ang = angles_arr[aidx]
            alive = top_vals >= thr[top]
            return pt, ang, top_vals, alive

    def descend_layer(l, src_l, templ_l, ptLT, ang, score, alive, fidx):
        """One pyramid-descent step for the candidates of every frame
        (flat [M], candidate i on frame fidx[i]; of a stack, on template
        fidx[i] and the one frame), in chunks of candidates; the caller
        sorts alive-first so dead chunks at the end cost nothing."""
        if stacked:
            lv = stats[l]
            equal1, u8_templ = lv.result_equal1, lv.u8_valued
        else:
            mean, norm, inv_area, equal1, u8_templ = stats[l]
        # The descent-score kernel serves the chunks on the card where its
        # integer sums are exact: the ROIs hold integers in [0, 255] when
        # the warps round (quantize_warp) frames held to [0, 255] (host
        # frames by _check_u8, device frames by _prep_src's clip under
        # compute_dtype "bf16"), and the template when it is u8-valued; a
        # flat template (equal1) scores all ones. Everywhere else, and on
        # the CPU, the plain route (ops/ncc.py::descent_best).
        integer = (cfg.quantize_warp and cfg.compute_dtype == "bf16"
                   and u8_templ)
        Cl = ptLT.shape[0]
        sh_l, sw_l = src_sizes[l]
        th_l, tw_l = plan.templ_shapes[l]
        center = (f32((sw_l - 1) / 2.0), f32((sh_l - 1) / 2.0))
        center_t = torch.tensor(center, dtype=torch.float32, device=dev)
        step_deg = geometry.angle_step((th_l, tw_l))
        roi_hw = (th_l + 6, tw_l + 6)

        if k_ang == 1:
            angs = torch.zeros((Cl, 1), dtype=torch.float32, device=dev)
        else:
            offs = torch.tensor([-step_deg, 0.0, step_deg],
                                dtype=torch.float32, device=dev)
            angs = ang[:, None] + offs[None, :]

        ptLT2 = ptLT * 2.0

        # Pure-translation path (tol=0, single angle 0): one slice per
        # candidate and a bilinear blend with per-candidate fractions.
        pad_h, pad_w = roi_hw[0] + 8, roi_hw[1] + 8
        src_l_padded = None
        if k_ang == 1:
            src_l_padded = torch.nn.functional.pad(
                src_l, (pad_w, pad_w, pad_h, pad_h))
            if stacked:  # the one frame as a row a template (a view)
                src_l_padded = src_l_padded.expand(n_templ, -1, -1)

        def _translated_rois(p2, f):
            # ROI dst (x, y) samples src at (x + p2x - 3, y + p2y - 3).
            sx = p2[:, 0] - 3.0
            sy = p2[:, 1] - 3.0
            x0 = torch.floor(sx)
            y0 = torch.floor(sy)
            fx = (sx - x0)[:, None, None]
            fy = (sy - y0)[:, None, None]
            xi = torch.clamp(x0.to(torch.int64) + pad_w, 0,
                             src_l_padded.shape[-1] - roi_hw[1] - 1)
            yi = torch.clamp(y0.to(torch.int64) + pad_h, 0,
                             src_l_padded.shape[-2] - roi_hw[0] - 1)
            rr = yi[:, None] + torch.arange(roi_hw[0] + 1, device=dev)
            cc = xi[:, None] + torch.arange(roi_hw[1] + 1, device=dev)
            big = src_l_padded[f[:, None, None], rr[:, :, None],
                               cc[:, None, :]]
            out = ((1 - fx) * (1 - fy) * big[:, :-1, :-1]
                   + fx * (1 - fy) * big[:, :-1, 1:]
                   + (1 - fx) * fy * big[:, 1:, :-1]
                   + fx * fy * big[:, 1:, 1:])
            if cfg.quantize_warp:
                out = torch.round(out)
            return out

        def rois(p2, a_flat, f):
            """The candidates' ROIs [cc * k_ang, h + 6, w + 6] at their
            angles a_flat, ROI b on row f[b] (f: [cc * k_ang]). A stack's
            rows are its templates on the one frame, whose index the warp
            drops (ops/warp.py::warp_affine_dispatch)."""
            if k_ang == 1:
                with span("fipm.descent.warp"):
                    return _translated_rois(p2, f)
            with span("fipm.descent.maps"):
                p2_rep = torch.repeat_interleave(p2, k_ang, dim=0)
                lt_rot = rotate_pt(p2_rep, center_t, a_flat * f32(D2R))
                shift = -(lt_rot - 3.0)
                invm = make_rotation_invmaps(center, a_flat, shift)
            with span("fipm.descent.warp"):
                return warp_affine_dispatch(
                    src_l, invm.contiguous(), roi_hw, 0.0,
                    quantize=cfg.quantize_warp, src_index=f)

        def cand_chunk(args):
            with span("fipm.descent.chunk"):
                p2, aa, f = args  # [cc, 2], [cc, k_ang], [cc]
                cc = p2.shape[0]
                # Each ROI's row: its frame, of a stack its template.
                fk = f if k_ang == 1 else torch.repeat_interleave(f, k_ang)
                roi = rois(p2, aa.reshape(cc * k_ang), fk)
                if not stacked:
                    return descent_best(roi, templ_l, mean, norm, inv_area,
                                        equal1, cc, k_ang, integer)
                return descent_best_stack(roi, templ_l, fk.to(torch.int32),
                                          lv.consts, equal1, cc, k_ang,
                                          integer)

        chunk = _descend_chunk(roi_hw, th_l * tw_l, k_ang)
        v, xy, border, patch = chunked_map(cand_chunk, (ptLT2, angs, fidx),
                                           Cl, chunk, pred=alive,
                                           count_as="descent")

        with span("fipm.descent.pick"):
            imax = torch.argmax(v, dim=1)  # first max wins, like :993
            ar = torch.arange(Cl, device=dev)
            best_v = v[ar, imax]
            best_xy = xy[ar, imax].to(torch.float32)
            best_border = border[ar, imax]
            best_ang = angs[ar, imax]
            alive = alive & (best_v >= thr[l])
            score = best_v

            if cfg.use_subpixel and l == 0 and k_ang == 3:
                with span("fipm.descent.subpixel"):
                    sub = subpixel_refine(patch, step_deg * D2R)
                    gate = (imax == 1) & ~best_border
                    best_xy = torch.where(gate[:, None],
                                          best_xy + sub[:, :2], best_xy)
                    best_ang = torch.where(
                        gate, best_ang + sub[:, 2] * f32(R2D), best_ang)

            pad_lt = rotate_pt(ptLT2, center_t, best_ang * f32(D2R)) - 3.0
            pt = best_xy + pad_lt
            pt = rotate_pt(pt, center_t, -best_ang * f32(D2R))
            return pt, best_ang, score, alive, fidx

    def unrotate(pt, ang):
        """Top-layer candidates [N, C] back to the source frame, flattened
        to [N * C] with their frame indices."""
        with span("fipm.select"):
            sh_t, sw_t = src_sizes[top]
            center_top = torch.tensor([(sw_t - 1) / 2.0, (sh_t - 1) / 2.0],
                                      dtype=torch.float32, device=dev)
            N, Cn = ang.shape
            fidx = torch.arange(N, device=dev).repeat_interleave(Cn)
            return (rotate_pt(pt, center_top,
                              -ang * f32(D2R)).reshape(N * Cn, 2),
                    ang.reshape(N * Cn), fidx)

    def debug_candidates(src, templs, inv_mats, trans, valid_wh, angles_arr):
        """Top-layer candidate dump (the m_bDebugMode analogue,
        MatchToolDlg.cpp:897-931): every extracted and thresholded sweep
        peak as [N, C, 5] = (x, y at level-0 scale, angle deg, score,
        alive)."""
        with span("fipm.pyramid"):
            pyr = build_pyramid(prep_src(src), top)
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        ptLT = unrotate(pt, ang)[0].reshape(pt.shape) * (2.0 ** top)
        return torch.cat([ptLT, ang[..., None], score[..., None],
                          alive.to(torch.float32)[..., None]], dim=-1)

    def narrow(cands, n_frames):
        """Each frame's candidates cut to its top narrow_bound scorers."""
        cl = narrow_bound(cfg.max_pos)
        if cl >= cands[0].shape[0] // n_frames:
            return cands
        sel = narrowed(cands, n_frames, cl)
        return tuple(x[sel] for x in cands)

    def descend_level(l, pyr, templs, cands, n_frames):
        """One level of descend_range: the flat candidates (ptLT, ang,
        score, alive, fidx) of every frame sorted, optionally narrowed,
        and refined at layer l."""
        th_l, tw_l = plan.templ_shapes[l]
        roi_hw_l = (th_l + 6, tw_l + 6)
        # Alive-first stable sort across all frames (only reorders;
        # finalize re-sorts by score, and a candidate's descent does
        # not depend on its neighbours), so the descent pays for
        # ceil(n_alive/chunk) chunks. Restricted to one frame, the
        # order is that frame's own alive-first order.
        if cands[0].shape[0] > _descend_chunk(roi_hw_l, th_l * tw_l, k_ang):
            alive, score = cands[3], cands[2]
            key = alive.to(torch.float32) * 4.0 + score
            order = _sort_desc(key)
            cands = tuple(x[order] for x in cands)
        # Optional narrowing of each frame to its top scorers before
        # large layers; ties broken by (score desc, y, x, angle), the
        # finalize order.
        if cfg.narrow_candidates and th_l * tw_l > 4096:
            if narrow_hook is not None:
                cands = cands[:3] + (narrow_hook(*cands),) + cands[4:]
            else:
                cands = narrow(cands, n_frames)
        return descend_layer(l, pyr[l], templs[l], *cands)

    def descend_range(pyr, templs, ptLT, ang, score, alive, fidx, l_from,
                      l_to):
        """Pyramid descent over layers l_from..l_to (inclusive, downward)
        of the flat candidates of every frame."""
        cands = (ptLT, ang, score, alive, fidx)
        n_rows = n_templ * pyr[l_to].shape[0]
        with span("fipm.descent"):
            for l in range(l_from, l_to - 1, -1):
                with span(_LEVEL_SPANS[l]):
                    cands = descend_level(l, pyr, templs, cands, n_rows)
        return cands

    def descend(pyr, templs, pt, ang, score, alive):
        """Initial un-rotation + full pyramid descent to the stop layer;
        returns the flat candidates of every frame and their frames."""
        ptLT, ang, fidx = unrotate(pt, ang)
        score, alive = score.reshape(-1), alive.reshape(-1)
        if top <= stop:
            scale = 1.0 if top == 0 else 2.0
            return ptLT * scale, ang, score, alive, fidx
        ptLT, ang, score, alive, fidx = descend_range(
            pyr, templs, ptLT, ang, score, alive, fidx, top - 1, stop)
        scale = 1.0 if stop == 0 else 2.0
        return ptLT * scale, ang, score, alive, fidx

    def finalize(final_pt, final_ang, score, alive, fidx, n_frames,
                 nms_cap=None):
        """Per frame: score cut, deterministic sort, NMS, top max_pos.
        Flat candidates -> [N, max_pos] results; nms_overflow [N]."""
        with span("fipm.finalize"):
            cap = plan.nms_cap if nms_cap is None else nms_cap
            grp = _by_frame(fidx, n_frames)
            final_pt, final_ang, score, alive = (
                x[grp] for x in (final_pt, final_ang, score, alive))
            # FilterWithScore (MatchToolDlg.cpp:1481-1497): sort desc + cut,
            # ties by (score desc, y, x, angle).
            ok = alive & (score >= thr[0])
            svals = torch.where(ok, score, -1.0)
            order = _lexsort((final_ang, final_pt[..., 0], final_pt[..., 1],
                              -svals))
            score_s = _rows(svals, order)
            pt_s = _rows(final_pt, order)
            ang_s = _rows(final_ang, order)
            ok_s = _rows(ok, order)

            # FilterWithRotatedRect (:1498-1557) on stop-layer-scaled dims.
            th0, tw0 = plan.templ_shapes[stop]
            rw = tw0 * (1.0 if stop == 0 else 2.0)
            rh = th0 * (1.0 if stop == 0 else 2.0)
            quads = rotated_rect_corners(pt_s, ang_s, rw, rh)
            C_all = quads.shape[1]
            with span("fipm.nms"):
                if cap < C_all:
                    keep = torch.cat([
                        filter_overlaps(quads[:, :cap], ok_s[:, :cap],
                                        rw * rh, cfg.max_overlap),
                        torch.zeros((n_frames, C_all - cap),
                                    dtype=torch.bool, device=dev)], dim=1)
                    overflow = ok_s.sum(dim=1) > cap
                else:
                    keep = filter_overlaps(quads, ok_s, rw * rh,
                                           cfg.max_overlap)
                    overflow = torch.zeros(n_frames, dtype=torch.bool,
                                           device=dev)

            with span("fipm.finalize.pick"):
                return _pick(keep, score_s, pt_s, ang_s, overflow,
                             cfg.max_pos, plan.templ_shapes[0])

    def prep_src(src):
        return _prep_src(src, cfg)

    def candidates(pyr, templs, inv_mats, trans, valid_wh, angles_arr):
        """Sweep, selection and descent on a built source pyramid: the
        flat candidates of every frame (of a stack: every template) that
        finalize takes."""
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        return descend(pyr, templs, pt, ang, score, alive)

    return types.SimpleNamespace(
        sweep_maps=sweep_maps,
        select_candidates=select_candidates, descend_range=descend_range,
        unrotate=unrotate, descend=descend,
        debug_candidates=debug_candidates, finalize=finalize,
        prep_src=prep_src, candidates=candidates)


class TemplateMatcher:
    """OO wrapper mirroring the Qt TemplateMatcher surface
    (include/TemplateMatcher.h:16-51): learnPattern / match / setters."""

    def __init__(self, config: Optional[MatchConfig] = None, device=None):
        self.config = config or MatchConfig()
        self.device = resolve_device(device)
        self.pattern: Optional[LearnedPattern] = None

    def learn_pattern(self, templ: np.ndarray) -> None:
        self.pattern = learn_pattern(templ, self.config.min_reduce_area,
                                     device=self.device)

    def match(self, src) -> List[MatchResult]:
        if self.pattern is None:
            raise RuntimeError("learn_pattern must be called first")
        return match(src, self.pattern, self.config, device=self.device)

    def _set(self, **kw) -> None:
        self.config = dataclasses.replace(self.config, **kw)

    def set_max_positions(self, n: int) -> None:
        self._set(max_pos=n)

    def set_max_overlap(self, v: float) -> None:
        self._set(max_overlap=v)

    def set_score(self, v: float) -> None:
        self._set(score=v)

    def set_tolerance_angle(self, v: float) -> None:
        self._set(tolerance_angle=v)

    def set_min_reduce_area(self, v: int) -> None:
        # A new pyramid depth invalidates the learned pattern.
        self._set(min_reduce_area=v)
        self.pattern = None

    def set_sub_pixel(self, enabled: bool) -> None:
        self._set(use_subpixel=enabled)

    def set_tolerance_ranges(self, t1: float, t2: float, t3: float,
                             t4: float) -> None:
        self._set(tolerance_ranges=(t1, t2, t3, t4))


def _check_u8(src) -> None:
    """The u8-value contract on host input (the reference works on 8-bit
    images throughout); device tensors are clipped by _prep_src."""
    if isinstance(src, np.ndarray) and src.dtype != np.uint8:
        lo, hi = float(src.min()), float(src.max())
        if lo < 0.0 or hi > 255.0:
            raise ValueError(
                f"source values must lie in [0, 255] (8-bit contract, "
                f"got range [{lo}, {hi}]); rescale 16-bit imagery first")


def upload_frames(srcs, dev) -> torch.Tensor:
    """Frames [N, H, W] (or one image) as f32 on `dev`, in one copy. A
    tensor already on `dev` is taken as it is (cast when it is not f32).
    Host u8 frames go up as u8 and are cast on the device: the values are
    the same and the copy moves a quarter of the bytes."""
    if not torch.is_tensor(srcs):
        arr = np.ascontiguousarray(srcs)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        srcs = torch.from_numpy(arr)
    with span("fipm.upload"):
        return srcs.to(dev).to(torch.float32)


def _pattern_inputs(pattern: LearnedPattern, dev):
    """Per-level stats and the template pyramid on `dev`."""
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1,
                   lv.u8_valued) for lv in pattern.levels)
    templs = tuple(torch.tensor(np.asarray(lv.templ, np.float32),
                                device=dev) for lv in pattern.levels)
    return stats, templs


def _sweep_inputs(plan: _Plan, dev) -> Tuple[torch.Tensor, ...]:
    """The sweep arrays of _top_sweep_arrays on `dev`."""
    return tuple(torch.as_tensor(a, device=dev)
                 for a in _top_sweep_arrays(plan))


def _plan_inputs(src_hw, pattern: LearnedPattern, cfg: MatchConfig, dev):
    """Plan, stats, template pyramid and sweep arrays on `dev`."""
    plan = _make_plan(tuple(src_hw), pattern, cfg)
    stats, templs = _pattern_inputs(pattern, dev)
    return plan, stats, (templs,) + _sweep_inputs(plan, dev)


def _stack_inputs(patterns: List[LearnedPattern], dev):
    """The stats (a StackLevel per level) and the template stacks
    [G, h_l, w_l] of G patterns of one plan on `dev`: every level's
    templates and constants table (ops/ncc.py::score_constants, on the
    host as for one pattern) go up in one host-to-device copy."""
    levels = list(zip(*(p.levels for p in patterns)))
    host = []
    for lvs in levels:
        h, w = lvs[0].templ.shape
        host += [np.stack([np.asarray(lv.templ, np.float32) for lv in lvs]),
                 np.array([score_constants(lv.mean, lv.norm, lv.inv_area,
                                           float(h * w)) for lv in lvs],
                          np.float32)]
    flat = torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a in host])).to(dev)
    on_dev = [v.view(a.shape) for v, a in
              zip(torch.split(flat, [a.size for a in host]), host)]
    stats = tuple(StackLevel(consts=c,
                             result_equal1=bool(lvs[0].result_equal1),
                             u8_valued=all(lv.u8_valued for lv in lvs))
                  for lvs, c in zip(levels, on_dev[1::2]))
    return stats, tuple(on_dev[::2])


def _check_area(pattern: LearnedPattern, src_hw) -> None:
    """The template's area against the frame's: the guard of match_many
    (and of the JAX package's batch), a part of _check_sizes."""
    t0 = pattern.levels[0].templ
    if t0.shape[0] * t0.shape[1] > src_hw[0] * src_hw[1]:
        raise ValueError("template larger than source")


def _check_sizes(pattern: LearnedPattern, src_hw) -> None:
    """Guards per Match() (MatchToolDlg.cpp:774-781)."""
    t0 = pattern.levels[0].templ
    if (t0.shape[0] > src_hw[0] and t0.shape[1] < src_hw[1]) or \
       (t0.shape[0] < src_hw[0] and t0.shape[1] > src_hw[1]):
        raise ValueError("template/source size relation unsupported")
    _check_area(pattern, src_hw)


def _frames(srcs, one: bool = False):
    """The input step of every entry: a caller's frames [N, H, W] (numpy
    or a tensor; one=True: a single image [H, W]) as frames [N, H, W], a
    trailing colour axis turned grey, the u8-value contract checked. Each
    entry then guards the sizes it serves."""
    if not torch.is_tensor(srcs):
        srcs = np.asarray(srcs)
    if one:
        srcs = srcs[None]
    if srcs.ndim == 4:
        from ..utils.imageio import ensure_gray
        srcs = ensure_gray(srcs)
    if srcs.ndim != 3:
        raise ValueError(f"srcs must be [B, H, W], got shape "
                         f"{tuple(srcs.shape)}")
    _check_u8(srcs)
    return srcs


def _pack_result(out, max_pos: int) -> torch.Tensor:
    """The results of N frames as one [N, max_pos + 1, 13] f32 tensor
    (rows: score, angle, center xy, corners 8, valid; each frame's last
    row carries its NMS-overflow flag), for a single host copy."""
    N = out["score"].shape[0]
    rows = torch.cat([
        out["score"][..., None], out["angle"][..., None], out["center"],
        out["corners"].reshape(N, max_pos, 8),
        out["valid"].to(torch.float32)[..., None]], dim=-1)
    flag = out["nms_overflow"].to(torch.float32)[:, None, None]
    return torch.cat([rows, flag.expand(N, 1, rows.shape[-1])], dim=1)


def _unpack_result(packed: np.ndarray) -> Dict[str, np.ndarray]:
    """One frame's [max_pos + 1, 13] rows of _pack_result -> result
    arrays. A row that holds no match reads score -1 and zeros (the
    JAX package's empty result), whatever candidate finalize left in it."""
    packed = packed[:-1].copy()
    packed[packed[:, 12] <= 0.5, 1:12] = 0.0
    mp = packed.shape[0]
    return {
        "score": packed[:, 0].astype(np.float32),
        "angle": packed[:, 1].astype(np.float32),
        "center": packed[:, 2:4].astype(np.float32),
        "corners": packed[:, 4:12].reshape(mp, 4, 2).astype(np.float32),
        "valid": packed[:, 12] > 0.5,
    }


def _stacked(outs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Per-frame result arrays stacked along a leading frame axis."""
    return {k: np.stack([o[k] for o in outs])
            for k in ("score", "angle", "center", "corners", "valid")}


def _finalized(plan: _Plan, finalize) -> List[Dict[str, np.ndarray]]:
    """The NMS-cap rule of every entry. finalize(nms_cap) gives the packed
    results (_pack_result) of every frame of a call, or every pattern of a
    group, finalized under that cap (None: the plan's); they come back in
    one host copy. When a frame holds more above-threshold candidates than
    the cap (its overflow flag), all are finalized again with the cap
    lifted, on the candidates the descent gave already: finalize is the
    only stage the cap changes, so that is the exact uncapped greedy
    result. Returns each frame's result arrays."""
    packed = finalize(None)
    with span("fipm.readback"):
        packed = packed.cpu().numpy()
    if plan.nms_cap < plan.c_max and bool((packed[:, -1, 0] > 0.5).any()):
        packed = finalize(plan.c_max)
        with span("fipm.readback"):
            packed = packed.cpu().numpy()
    return [_unpack_result(p) for p in packed]


def _run(plan: _Plan, st, args) -> List[Dict[str, np.ndarray]]:
    """The stages on the frames args[0] [N, H, W] on the device (args:
    those frames, the template pyramid and the sweep arrays): pyramid,
    sweep, selection, descent, then finalize under _finalized's rule.
    Returns each frame's result arrays."""
    frames, templs, *sweep = args
    with span("fipm.pyramid"):
        pyr = build_pyramid(st.prep_src(frames), plan.top)
    cands = st.candidates(pyr, templs, *sweep)
    return _finalized(plan, lambda cap: _pack_result(
        st.finalize(*cands, frames.shape[0], cap), plan.cfg.max_pos))


def _match_frames(frames, pattern: LearnedPattern, cfg: MatchConfig,
                  device) -> List[Dict[str, np.ndarray]]:
    """The path of match and match_many: frames [N, H, W] from _frames,
    their sizes guarded by their entry, get a plan, stage functions and
    one upload (fipm.prepare), then _run. One frame is the case N = 1."""
    dev = resolve_device(device)
    with span("fipm.prepare"):
        plan, stats, args = _plan_inputs(frames.shape[1:], pattern, cfg, dev)
        st = build_stages(plan, stats, dev)
        args = (upload_frames(frames, dev),) + args
    return _run(plan, st, args)


def match_candidates(src, pattern: LearnedPattern,
                     cfg: Optional[MatchConfig] = None,
                     device=None) -> Dict[str, np.ndarray]:
    """Debug candidate dump: every thresholded top-layer sweep peak before
    refinement, the analogue of the reference's m_bDebugMode candidate
    overlay (MatchToolDlg.cpp:897-931). Returns a dict of [C] numpy
    arrays: x, y (LT corner at level-0 scale, top-layer frame), angle (deg,
    sweep convention), score (top-layer NCC), alive (above the layer
    threshold)."""
    cfg = cfg or MatchConfig()
    dev = resolve_device(device)
    frames = _frames(src, one=True)
    _check_sizes(pattern, frames.shape[1:])
    plan, stats, args = _plan_inputs(frames.shape[1:], pattern, cfg, dev)
    packed = build_stages(plan, stats, dev).debug_candidates(
        upload_frames(frames, dev), *args)[0]
    packed = packed.cpu().numpy()
    return {"x": packed[:, 0], "y": packed[:, 1], "angle": packed[:, 2],
            "score": packed[:, 3], "alive": packed[:, 4] > 0.5}


def match_arrays(src, pattern: LearnedPattern, cfg: MatchConfig,
                 device=None) -> Dict[str, np.ndarray]:
    """Run the pipeline on one image (a batch of one frame); returns
    fixed-size result arrays (score / angle / center / corners [max_pos],
    valid mask) as numpy."""
    with span("fipm.match"):
        return _match_arrays(src, pattern, cfg, device)


def _match_arrays(src, pattern: LearnedPattern, cfg: MatchConfig, device):
    frames = _frames(src, one=True)
    _check_sizes(pattern, frames.shape[1:])
    return _match_frames(frames, pattern, cfg, device)[0]


def match(src, pattern: LearnedPattern, cfg: Optional[MatchConfig] = None,
          device=None) -> List[MatchResult]:
    """Find template instances in src; returns MatchResults sorted by score
    desc, at most cfg.max_pos entries."""
    cfg = cfg or MatchConfig()
    with span("fipm.match"):
        out = _match_arrays(src, pattern, cfg, device)
        with span("fipm.results"):
            return _results(out, pattern)


def _results(out: Dict[str, np.ndarray], pattern: LearnedPattern
             ) -> List[MatchResult]:
    """The valid rows of one frame's result arrays as MatchResults."""
    results = []
    for i in range(out["valid"].shape[0]):
        if not out["valid"][i]:
            continue
        c = out["corners"][i]
        r = MatchResult(
            score=float(out["score"][i]), angle=float(out["angle"][i]),
            center=tuple(out["center"][i].tolist()),
            lt=tuple(c[0].tolist()), rt=tuple(c[1].tolist()),
            rb=tuple(c[2].tolist()), lb=tuple(c[3].tolist()))
        if pattern.regions:
            r.regions = tuple(r.project_points(reg)
                              for reg in pattern.regions)
        results.append(r)
    return results


def match_template(src, templ, method: str = "auto",
                   compute_dtype: str = "bf16", device=None) -> np.ndarray:
    """Plain full-resolution TM_CCOEFF_NORMED score map, the
    cv::matchTemplate equivalent without a pyramid (BASELINE config 1).

    method: as ops/ncc.py::ncc_score_map ("auto" picks the correlation
    kernel on the card for large maps and small templates, fft or conv
    otherwise). compute_dtype is accepted for the JAX package's signature
    and has no effect: the port's correlations are exact on u8-valued
    inputs whatever it says (fft aside, ~1e-7 relative)."""
    del compute_dtype
    dev = resolve_device(device)
    src = np.asarray(src)
    templ = np.asarray(templ)
    if src.ndim == 3 or templ.ndim == 3:
        from ..utils.imageio import ensure_gray
        src = ensure_gray(src) if src.ndim == 3 else src
        templ = ensure_gray(templ) if templ.ndim == 3 else templ
    area = templ.size
    mean = float(np.mean(templ, dtype=np.float64))
    var = float(np.mean((templ.astype(np.float64) - mean) ** 2))
    norm = float(np.sqrt(var) * np.sqrt(area))
    out = ncc_score_map(
        torch.as_tensor(src.astype(np.float32), device=dev)[None],
        torch.as_tensor(templ.astype(np.float32), device=dev),
        mean, norm, 1.0 / area, var < DBL_EPSILON, method)
    return out[0].cpu().numpy()
