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
from ..ops.pyramid import build_pyramid
from ..ops.ncc import ncc_score_map
from ..ops.peaks import extract_peaks
from ..ops.nms import filter_overlaps, rotated_rect_corners
from ..ops.subpixel import subpixel_refine
from ..ops.rounding import f32
from ..ops.warp import make_rotation_invmaps, rotate_pt, warp_affine_dispatch

DBL_EPSILON = 2.220446049250313e-16

# Device-memory budget per chunked stage, in f32 elements (the JAX
# package's value, kept so that both cut the work into the same chunks).
_CHUNK_BUDGET_ELEMS = 128 * 1024 * 1024


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
    """jnp.lexsort: the LAST key is primary. Chained stable ascending
    sorts, from the least significant key to the most."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


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
    # finalize flags an overflow and match_arrays re-dispatches uncapped.
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


def build_stages(plan: _Plan, stats, device):
    """The pipeline stage functions for a static plan on `device`.

    stats: per level (mean, norm, inv_area, result_equal1) as Python
    values. Returns a namespace of the stage functions; match_fn composes
    them."""
    dev = torch.device(device)
    cfg = plan.cfg
    thr = torch.tensor(plan.layer_scores, dtype=torch.float32, device=dev)
    top, stop = plan.top, plan.stop
    th_t, tw_t = plan.templ_shapes[top]
    Hc, Wc = plan.canvas_hw
    K = plan.k_peaks
    C = plan.c_max
    k_ang = plan.k_ang
    src_sizes = geometry.pyramid_sizes(plan.src_hw, top)
    # The JAX package clips the source to [0, 255] when its correlation runs
    # in int8; the same inputs are clipped here so results agree on
    # out-of-contract device input as well.
    clip_src = cfg.compute_dtype == "bf16" and cfg.quantize_warp

    def sweep_maps(src_top, templ_top, inv_mats, valid_wh):
        """Per-angle score-map peaks: [a, 2, 3], [a, 2] -> vals [a, K],
        locs [a, K, 2]."""
        mean, norm, inv_area, equal1 = stats[top]
        Ho, Wo = Hc - th_t + 1, Wc - tw_t + 1
        xs = torch.arange(Wo, dtype=torch.int32, device=dev)[None, None, :]
        ys = torch.arange(Ho, dtype=torch.int32, device=dev)[None, :, None]
        identity_sweep = (len(plan.angles) == 1 and plan.angles[0] == 0.0)

        def sweep_chunk(args):
            inv_m, vwh = args
            if identity_sweep:
                # tol=0: the rotation canvas is the source itself.
                canv = src_top[None].expand(inv_m.shape[0], *src_top.shape)
                canv = torch.nn.functional.pad(
                    canv, (0, Wc - src_top.shape[1], 0, Hc - src_top.shape[0]),
                    value=float(plan.border_color))
            else:
                canv = warp_affine_dispatch(
                    src_top, inv_m, (Hc, Wc), float(plan.border_color),
                    quantize=cfg.quantize_warp)
            smap = ncc_score_map(canv, templ_top, mean, norm, inv_area,
                                 equal1)
            ok = ((xs <= (vwh[:, 0] - tw_t)[:, None, None])
                  & (ys <= (vwh[:, 1] - th_t)[:, None, None]))
            smap = torch.where(ok, smap, -1.0)
            return extract_peaks(smap, K, (tw_t, th_t), cfg.max_overlap)

        chunk = max(1, _CHUNK_BUDGET_ELEMS // (Hc * Wc * 4))
        return chunked_map(sweep_chunk, (inv_mats, valid_wh),
                           inv_mats.shape[0], chunk)

    def select_candidates(vals, locs, trans, angles_arr):
        """Flatten per-angle peaks, threshold, global top-C (the reference
        sorts all candidates by score, MatchToolDlg.cpp:890)."""
        n_ang = vals.shape[0]
        vals_f = vals.reshape(n_ang * K)
        locs_f = locs.reshape(n_ang * K, 2)
        masked = torch.where(vals_f >= thr[top], vals_f, -1.0)
        top_idx = _sort_desc(masked)[:C]
        top_vals = masked[top_idx]
        aidx = top_idx // K
        pt = locs_f[top_idx].to(torch.float32) - trans[aidx]
        ang = angles_arr[aidx]
        alive = top_vals >= thr[top]
        return pt, ang, top_vals, alive

    def descend_layer(l, src_l, templ_l, ptLT, ang, score, alive):
        """One pyramid-descent step for all candidates, in chunks of
        candidates; the caller sorts alive-first so dead chunks at the end
        cost nothing."""
        mean, norm, inv_area, equal1 = stats[l]
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

        def _translated_rois(p2):
            # ROI dst (x, y) samples src at (x + p2x - 3, y + p2y - 3).
            sx = p2[:, 0] - 3.0
            sy = p2[:, 1] - 3.0
            x0 = torch.floor(sx)
            y0 = torch.floor(sy)
            fx = (sx - x0)[:, None, None]
            fy = (sy - y0)[:, None, None]
            xi = torch.clamp(x0.to(torch.int64) + pad_w, 0,
                             src_l_padded.shape[1] - roi_hw[1] - 1)
            yi = torch.clamp(y0.to(torch.int64) + pad_h, 0,
                             src_l_padded.shape[0] - roi_hw[0] - 1)
            rr = yi[:, None] + torch.arange(roi_hw[0] + 1, device=dev)
            cc = xi[:, None] + torch.arange(roi_hw[1] + 1, device=dev)
            big = src_l_padded[rr[:, :, None], cc[:, None, :]]
            out = ((1 - fx) * (1 - fy) * big[:, :-1, :-1]
                   + fx * (1 - fy) * big[:, :-1, 1:]
                   + (1 - fx) * fy * big[:, 1:, :-1]
                   + fx * fy * big[:, 1:, 1:])
            if cfg.quantize_warp:
                out = torch.round(out)
            return out

        def cand_chunk(args):
            p2, aa = args  # [cc, 2], [cc, k_ang]
            cc = p2.shape[0]
            a_flat = aa.reshape(cc * k_ang)
            if k_ang == 1:
                roi = _translated_rois(p2)
            else:
                p2_rep = torch.repeat_interleave(p2, k_ang, dim=0)
                lt_rot = rotate_pt(p2_rep, center_t, a_flat * f32(D2R))
                shift = -(lt_rot - 3.0)
                invm = make_rotation_invmaps(center, a_flat, shift)
                roi = warp_affine_dispatch(src_l, invm.contiguous(), roi_hw,
                                           0.0, quantize=cfg.quantize_warp)
            smap = ncc_score_map(roi, templ_l, mean, norm, inv_area,
                                 equal1)  # [cc*k, 7, 7]
            flat = smap.reshape(cc * k_ang, 49)
            fi = torch.argmax(flat, dim=1)
            v = flat[torch.arange(cc * k_ang, device=dev), fi]
            py = (fi // 7).to(torch.int32)
            px = (fi % 7).to(torch.int32)
            border = (px == 0) | (px == 6) | (py == 0) | (py == 6)
            sy = torch.clamp(py - 1, 0, 4).to(torch.int64)
            sx = torch.clamp(px - 1, 0, 4).to(torch.int64)
            r3 = torch.arange(3, device=dev)
            patch = smap[torch.arange(cc * k_ang, device=dev)[:, None, None],
                         (sy[:, None] + r3)[:, :, None],
                         (sx[:, None] + r3)[:, None, :]]
            return (v.reshape(cc, k_ang),
                    torch.stack([px, py], -1).reshape(cc, k_ang, 2),
                    border.reshape(cc, k_ang),
                    patch.reshape(cc, k_ang, 3, 3))

        chunk = _descend_chunk(roi_hw, th_l * tw_l, k_ang)
        v, xy, border, patch = chunked_map(cand_chunk, (ptLT2, angs), Cl,
                                           chunk, pred=alive)

        imax = torch.argmax(v, dim=1)  # first max wins, like :993
        ar = torch.arange(Cl, device=dev)
        best_v = v[ar, imax]
        best_xy = xy[ar, imax].to(torch.float32)
        best_border = border[ar, imax]
        best_ang = angs[ar, imax]
        alive = alive & (best_v >= thr[l])
        score = best_v

        if cfg.use_subpixel and l == 0 and k_ang == 3:
            sub = subpixel_refine(patch, step_deg * D2R)
            gate = (imax == 1) & ~best_border
            best_xy = torch.where(gate[:, None], best_xy + sub[:, :2],
                                  best_xy)
            best_ang = torch.where(gate, best_ang + sub[:, 2] * f32(R2D),
                                   best_ang)

        pad_lt = rotate_pt(ptLT2, center_t, best_ang * f32(D2R)) - 3.0
        pt = best_xy + pad_lt
        pt = rotate_pt(pt, center_t, -best_ang * f32(D2R))
        return pt, best_ang, score, alive

    def unrotate(pt, ang):
        sh_t, sw_t = src_sizes[top]
        center_top = torch.tensor([(sw_t - 1) / 2.0, (sh_t - 1) / 2.0],
                                  dtype=torch.float32, device=dev)
        return rotate_pt(pt, center_top, -ang * f32(D2R))

    def debug_candidates(src, templs, inv_mats, trans, valid_wh, angles_arr):
        """Top-layer candidate dump (the m_bDebugMode analogue,
        MatchToolDlg.cpp:897-931): every extracted and thresholded sweep
        peak as [C, 5] = (x, y at level-0 scale, angle deg, score,
        alive)."""
        pyr = build_pyramid(prep_src(src), top)
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        ptLT = unrotate(pt, ang) * (2.0 ** top)
        return torch.cat([ptLT, ang[:, None], score[:, None],
                          alive.to(torch.float32)[:, None]], dim=1)

    def descend_range(pyr, templs, ptLT, ang, score, alive, l_from, l_to):
        """Pyramid descent over layers l_from..l_to (inclusive, downward)."""
        for l in range(l_from, l_to - 1, -1):
            th_l, tw_l = plan.templ_shapes[l]
            roi_hw_l = (th_l + 6, tw_l + 6)
            # Alive-first stable sort (only reorders; finalize re-sorts by
            # score), so the descent pays for ceil(n_alive/chunk) chunks.
            if ptLT.shape[0] > _descend_chunk(roi_hw_l, th_l * tw_l, k_ang):
                key = alive.to(torch.float32) * 4.0 + score
                order = _sort_desc(key)
                ptLT, ang, score, alive = (ptLT[order], ang[order],
                                           score[order], alive[order])
            # Optional narrowing to the top scorers before large layers;
            # ties broken by (score desc, y, x, angle), the finalize order.
            if cfg.narrow_candidates and th_l * tw_l > 4096:
                cl = min(ptLT.shape[0], max(2 * cfg.max_pos + 4, 16))
                if cl < ptLT.shape[0]:
                    key = torch.where(alive, score, -2.0)
                    order = _lexsort((ang, ptLT[:, 0], ptLT[:, 1], -key))[:cl]
                    ptLT, ang, score, alive = (ptLT[order], ang[order],
                                               score[order], alive[order])
            ptLT, ang, score, alive = descend_layer(
                l, pyr[l], templs[l], ptLT, ang, score, alive)
        return ptLT, ang, score, alive

    def descend(pyr, templs, pt, ang, score, alive):
        """Initial un-rotation + full pyramid descent to the stop layer."""
        ptLT = unrotate(pt, ang)
        if top <= stop:
            scale = 1.0 if top == 0 else 2.0
            return ptLT * scale, ang, score, alive
        ptLT, ang, score, alive = descend_range(
            pyr, templs, ptLT, ang, score, alive, top - 1, stop)
        scale = 1.0 if stop == 0 else 2.0
        return ptLT * scale, ang, score, alive

    def finalize(final_pt, final_ang, score, alive, nms_cap=None):
        cap = plan.nms_cap if nms_cap is None else nms_cap
        # FilterWithScore (MatchToolDlg.cpp:1481-1497): sort desc + cut,
        # ties by (score desc, y, x, angle).
        ok = alive & (score >= thr[0])
        svals = torch.where(ok, score, -1.0)
        order = _lexsort((final_ang, final_pt[:, 0], final_pt[:, 1], -svals))
        score_s = svals[order]
        pt_s = final_pt[order]
        ang_s = final_ang[order]
        ok_s = ok[order]

        # FilterWithRotatedRect (:1498-1557) on stop-layer-scaled dims.
        th0, tw0 = plan.templ_shapes[stop]
        rw = tw0 * (1.0 if stop == 0 else 2.0)
        rh = th0 * (1.0 if stop == 0 else 2.0)
        quads = rotated_rect_corners(pt_s, ang_s, rw, rh)
        C_all = quads.shape[0]
        if cap < C_all:
            keep = torch.cat([
                filter_overlaps(quads[:cap], ok_s[:cap], rw * rh,
                                cfg.max_overlap),
                torch.zeros(C_all - cap, dtype=torch.bool, device=dev)])
            overflow = bool(ok_s.sum() > cap)
        else:
            keep = filter_overlaps(quads, ok_s, rw * rh, cfg.max_overlap)
            overflow = False

        svals2 = torch.where(keep, score_s, -1.0)
        if svals2.shape[0] < cfg.max_pos:  # narrowed below max_pos
            pad = cfg.max_pos - svals2.shape[0]
            svals2 = torch.nn.functional.pad(svals2, (0, pad), value=-1.0)
            pt_s = torch.nn.functional.pad(pt_s, (0, 0, 0, pad))
            ang_s = torch.nn.functional.pad(ang_s, (0, pad))
            keep = torch.nn.functional.pad(keep, (0, pad))
        ord2 = _sort_desc(svals2)[:cfg.max_pos]
        r_score = svals2[ord2]
        r_pt = pt_s[ord2]
        r_ang = ang_s[ord2]
        r_ok = keep[ord2] & (r_score >= 0)

        # Result assembly (MatchToolDlg.cpp:1082-1099): level-0 dims, angle
        # negation + wrap to (-180, 180].
        H0, W0 = plan.templ_shapes[0]
        corners = rotated_rect_corners(r_pt, r_ang, float(W0), float(H0))
        center = torch.mean(corners, dim=-2)
        out_ang = -r_ang
        out_ang = torch.where(out_ang < -180.0, out_ang + 360.0, out_ang)
        out_ang = torch.where(out_ang > 180.0, out_ang - 360.0, out_ang)
        return dict(score=r_score, angle=out_ang, corners=corners,
                    center=center, valid=r_ok, nms_overflow=overflow)

    def prep_src(src):
        """Input normalisation: u8-contract clip and bitwise-not."""
        if clip_src:
            src = torch.clamp(src, 0.0, 255.0)
        if cfg.bitwise_not:
            src = 255.0 - src
        return src

    def match_fn(src, templs, inv_mats, trans, valid_wh, angles_arr,
                 nms_cap=None):
        pyr = build_pyramid(prep_src(src), top)
        vals, locs = sweep_maps(pyr[top], templs[top], inv_mats, valid_wh)
        pt, ang, score, alive = select_candidates(vals, locs, trans,
                                                  angles_arr)
        final_pt, final_ang, score, alive = descend(pyr, templs, pt, ang,
                                                    score, alive)
        return finalize(final_pt, final_ang, score, alive, nms_cap)

    return types.SimpleNamespace(
        sweep_maps=sweep_maps, select_candidates=select_candidates,
        descend_range=descend_range, unrotate=unrotate, descend=descend,
        debug_candidates=debug_candidates,
        finalize=finalize, prep_src=prep_src, match_fn=match_fn)


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


def _prepare(src, pattern: LearnedPattern, cfg: MatchConfig, dev):
    """Input checks, plan, stats and device tensors."""
    if not torch.is_tensor(src):
        src = np.asarray(src)
    if src.ndim == 3:
        from ..utils.imageio import ensure_gray
        src = ensure_gray(src)
    # u8-value contract (the reference works on 8-bit images throughout).
    if isinstance(src, np.ndarray) and src.dtype != np.uint8:
        lo, hi = float(src.min()), float(src.max())
        if lo < 0.0 or hi > 255.0:
            raise ValueError(
                f"source values must lie in [0, 255] (8-bit contract, "
                f"got range [{lo}, {hi}]); rescale 16-bit imagery first")
    # Guards per Match() (MatchToolDlg.cpp:774-781).
    t0 = pattern.levels[0].templ
    if (t0.shape[0] > src.shape[0] and t0.shape[1] < src.shape[1]) or \
       (t0.shape[0] < src.shape[0] and t0.shape[1] > src.shape[1]):
        raise ValueError("template/source size relation unsupported")
    if t0.shape[0] * t0.shape[1] > src.shape[0] * src.shape[1]:
        raise ValueError("template larger than source")

    plan = _make_plan(tuple(src.shape), pattern, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pattern.levels)
    templs = tuple(torch.tensor(np.asarray(lv.templ, np.float32),
                                device=dev) for lv in pattern.levels)
    if torch.is_tensor(src):
        src_dev = src.to(device=dev, dtype=torch.float32)
    else:
        src_dev = torch.as_tensor(src.astype(np.float32), device=dev)
    arrays = tuple(torch.as_tensor(a, device=dev)
                   for a in _top_sweep_arrays(plan))
    return plan, stats, (src_dev, templs) + arrays


def _to_numpy(out) -> Dict[str, np.ndarray]:
    return {k: out[k].cpu().numpy()
            for k in ("score", "angle", "center", "corners", "valid")}


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
    plan, stats, args = _prepare(src, pattern, cfg, dev)
    packed = build_stages(plan, stats, dev).debug_candidates(*args)
    packed = packed.cpu().numpy()
    return {"x": packed[:, 0], "y": packed[:, 1], "angle": packed[:, 2],
            "score": packed[:, 3], "alive": packed[:, 4] > 0.5}


def match_arrays(src, pattern: LearnedPattern, cfg: MatchConfig,
                 device=None) -> Dict[str, np.ndarray]:
    """Run the pipeline; returns fixed-size result arrays (score / angle /
    center / corners [max_pos], valid mask) as numpy."""
    dev = resolve_device(device)
    plan, stats, args = _prepare(src, pattern, cfg, dev)
    st = build_stages(plan, stats, dev)
    out = st.match_fn(*args)
    if out["nms_overflow"] and plan.nms_cap < plan.c_max:
        # More above-threshold candidates than the NMS cap: run again with
        # the cap lifted for the exact uncapped greedy result.
        out = st.match_fn(*args, nms_cap=plan.c_max)
    return _to_numpy(out)


def match(src, pattern: LearnedPattern, cfg: Optional[MatchConfig] = None,
          device=None) -> List[MatchResult]:
    """Find template instances in src; returns MatchResults sorted by score
    desc, at most cfg.max_pos entries."""
    cfg = cfg or MatchConfig()
    out = match_arrays(src, pattern, cfg, device=device)
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
