"""The plain reference matcher: one frame, one template, in PyTorch.

A frozen copy of the port's coarse-to-fine pipeline as its plain version
runs it on one frame (itself the reference tool's LearnPattern and
Match()): the template pyramid and its f64 statistics, the source
pyramid, the top-layer angle sweep with greedy masked peaks, the global
top-C candidates, the descent layer by layer over the live candidates
with the quadratic subpixel fit at layer 0, the score cut, the
deterministic sort and the rotated-rect overlap filter. It imports
nothing of the port and takes nothing that the port made: it learns its
own pattern from the template's u8 array.

Where the port carries dead candidates through the descent in chunks, this
descends only the live ones; where the port filters overlaps in parallel
rounds, this walks the greedy order. Both give the same survivors.

`work`, when given, collects the least seconds of the algorithm's device
work for the roofline metrics (`roofline.py`), as ("warp", s) for every
warp (from its source, maps and output shape) and ("corr", s) for every
correlation of the large-map regime that the port serves with its
correlation kernel.

`answer` is the entry the harness calls, by the name `matcher` that a
configuration gives as its `reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from fipm_bench import roofline
from fipm_bench.reference import geometry as geo
from fipm_bench.reference import ops
from fipm_bench.reference.ops import f32

DBL_EPSILON = 2.220446049250313e-16
MATCH_CANDIDATE_NUM = 5
MAX_CANDIDATES = 2048
# Correlations with more outputs than this and a template the port's
# correlation kernel takes (2 <= w <= 129, h <= 64) are the kernel's.
LARGE_MAP_OUTPUTS = 65536

# The match settings this reference follows; every other one keeps the
# port's default (no bitwise-not, no fast mode, no angle ranges, every
# candidate refined, warps rounded to u8).
SETTINGS = ("max_pos", "max_overlap", "score", "tolerance_angle",
            "min_reduce_area", "use_subpixel")


def _lexsort(keys) -> torch.Tensor:
    """numpy's lexsort (last key primary) as chained stable sorts."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


def learn(templ_u8: np.ndarray, min_reduce_area: int, device):
    """Template pyramid (u8-valued f32 on `device`) and per-level
    (mean, norm, inv_area, flat) in f64 on the host."""
    t = torch.as_tensor(np.asarray(templ_u8, np.float32), device=device)
    top = geo.top_layer(t.shape, min_reduce_area)
    levels, stats = ops.pyramid(t, top), []
    for p in levels:
        a = p.cpu().numpy()
        mean = float(np.mean(a, dtype=np.float64))
        var = float(np.mean((a.astype(np.float64) - mean) ** 2))
        stats.append((mean, float(np.sqrt(var) * np.sqrt(float(a.size))),
                      1.0 / float(a.size), var < DBL_EPSILON))
    lvl0 = levels[0].cpu().numpy()
    border = 255 if float(np.mean(lvl0, dtype=np.float64)) < 128 else 0
    return levels, stats, border


def _check_settings(cfg: dict) -> None:
    unknown = sorted(set(cfg) - set(SETTINGS))
    if unknown:
        raise ValueError(f"the reference matcher does not follow the "
                         f"settings {unknown}")


def _sweep(src_top, templ_top, stats_top, cfg, plan, border, score_dtype,
           work):
    """Top-layer peaks of every angle's canvas -> vals [A, K], locs [A, K,
    2], translations [A, 2], angles [A] (f32)."""
    dev = src_top.device
    sh, sw = src_top.shape
    th, tw = templ_top.shape
    angles, (Hc, Wc), K = plan["angles"], plan["canvas_hw"], plan["k"]
    cx, cy = (sw - 1) / 2.0, (sh - 1) / 2.0
    inv, trans, vwh = [], [], []
    for a in angles:
        bw, bh = geo.best_rotation_size((sw, sh), (tw, th), a)
        t = ((bw - 1) / 2.0 - cx, (bh - 1) / 2.0 - cy)
        m = geo.rotation_matrix((cx, cy), a)
        m[0, 2] += t[0]
        m[1, 2] += t[1]
        inv.append(geo.invert_affine(m))
        trans.append(t)
        vwh.append((bw, bh))
    inv = torch.as_tensor(np.array(inv, np.float32), device=dev)
    vwh = torch.as_tensor(np.array(vwh, np.int32), device=dev)
    if len(angles) == 1 and angles[0] == 0.0:
        canv = torch.nn.functional.pad(
            src_top, (0, Wc - sw, 0, Hc - sh), value=float(border))[None]
    else:
        canv = ops.warp(src_top, inv, (Hc, Wc), float(border))
        if work is not None:
            work.append(("warp", roofline.warp_bound_s(src_top, inv,
                                                          (Hc, Wc))))
    vals, locs = [], []
    Ho, Wo = Hc - th + 1, Wc - tw + 1
    xs = torch.arange(Wo, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(Ho, dtype=torch.int32, device=dev)[None, :, None]
    # The angles one at a time: a canvas is a few MB at most.
    for i in range(len(angles)):
        c = canv[i:i + 1]
        if work is not None and Ho * Wo > LARGE_MAP_OUTPUTS \
                and 2 <= tw <= 129 and th <= 64:
            work.append(("corr", roofline.corr_bound_s(c - 128.0,
                                                          templ_top - 128.0)))
        smap = ops.ncc_map(c, templ_top, stats_top, score_dtype)
        ok = ((xs <= (vwh[i, 0] - tw)) & (ys <= (vwh[i, 1] - th)))
        smap = torch.where(ok, smap, -1.0)
        v, l = ops.peaks(smap, K, (tw, th), cfg["max_overlap"])
        vals.append(v[0])
        locs.append(l[0])
    return (torch.stack(vals), torch.stack(locs),
            torch.as_tensor(np.array(trans, np.float32), device=dev),
            torch.as_tensor(np.array(angles, np.float32), device=dev))


def _descend_level(l, src_l, templ_l, stats_l, pt_lt, ang, k_ang, cfg,
                   score_dtype, work):
    """One descent step of the live candidates (pt_lt [n, 2] at layer
    l + 1, ang [n]): the 7x7 score map of each candidate's (h+6)x(w+6) ROI
    at k_ang angles, its best, and at layer 0 the subpixel fit. Returns
    (pt_lt at layer l, angle, score) [n]."""
    dev = src_l.device
    n = pt_lt.shape[0]
    sh, sw = src_l.shape
    th, tw = templ_l.shape
    center = (f32((sw - 1) / 2.0), f32((sh - 1) / 2.0))
    center_t = torch.tensor(center, dtype=torch.float32, device=dev)
    step = geo.angle_step((th, tw))
    roi_hw = (th + 6, tw + 6)
    if k_ang == 1:
        angs = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    else:
        angs = ang[:, None] + torch.tensor([-step, 0.0, step],
                                           dtype=torch.float32,
                                           device=dev)[None, :]
    p2 = pt_lt * 2.0
    rois = []
    if k_ang == 1:
        # Pure translation: each ROI is a bilinear blend of one slice.
        ph, pw = roi_hw[0] + 8, roi_hw[1] + 8
        padded = torch.nn.functional.pad(src_l, (pw, pw, ph, ph))
        sx, sy = p2[:, 0] - 3.0, p2[:, 1] - 3.0
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - x0).tolist(), (sy - y0).tolist()
        xi = torch.clamp(x0.to(torch.int64) + pw, 0,
                         padded.shape[-1] - roi_hw[1] - 1).tolist()
        yi = torch.clamp(y0.to(torch.int64) + ph, 0,
                         padded.shape[-2] - roi_hw[0] - 1).tolist()
        for i in range(n):
            big = padded[yi[i]:yi[i] + roi_hw[0] + 1,
                         xi[i]:xi[i] + roi_hw[1] + 1]
            ax = torch.tensor(fx[i], dtype=torch.float32, device=dev)
            ay = torch.tensor(fy[i], dtype=torch.float32, device=dev)
            r = ((1 - ax) * (1 - ay) * big[:-1, :-1]
                 + ax * (1 - ay) * big[:-1, 1:]
                 + (1 - ax) * ay * big[1:, :-1] + ax * ay * big[1:, 1:])
            rois.append(torch.round(r)[None])
    else:
        a_flat = angs.reshape(n * 3)
        lt_rot = ops.rotate_pt(torch.repeat_interleave(p2, 3, dim=0),
                               center_t, a_flat * f32(geo.D2R))
        inv = ops.rotation_invmaps(center, a_flat, -(lt_rot - 3.0))
        # A few candidates a warp, so that the ROIs of the largest layers
        # fit in memory.
        per = max(1, (8 << 20) // (roi_hw[0] * roi_hw[1] * 3))
        for lo in range(0, n, per):
            m = inv[3 * lo:3 * min(n, lo + per)].contiguous()
            rois.append(ops.warp(src_l, m, roi_hw, 0.0))
            if work is not None:
                work.append(("warp", roofline.warp_bound_s(src_l, m, roi_hw)))
    vals, xys, borders, patches = [], [], [], []
    per = max(1, (64 << 20) // (roi_hw[0] * roi_hw[1] * 8))
    roi = torch.cat(rois) if rois else src_l.new_zeros((0,) + roi_hw)
    for lo in range(0, roi.shape[0], per):
        smap = ops.ncc_map(roi[lo:lo + per], templ_l, stats_l, score_dtype)
        m = smap.shape[0]
        flat = smap.reshape(m, 49)
        fi = torch.argmax(flat, dim=1)
        ar = torch.arange(m, device=dev)
        py, px = fi // 7, fi % 7
        sy = torch.clamp(py - 1, 0, 4)
        sx = torch.clamp(px - 1, 0, 4)
        r3 = torch.arange(3, device=dev)
        vals.append(flat[ar, fi])
        xys.append(torch.stack([px, py], -1))
        borders.append((px == 0) | (px == 6) | (py == 0) | (py == 6))
        patches.append(smap[ar[:, None, None], (sy[:, None] + r3)[:, :, None],
                            (sx[:, None] + r3)[:, None, :]])
    v = torch.cat(vals).reshape(n, k_ang)
    xy = torch.cat(xys).reshape(n, k_ang, 2)
    border = torch.cat(borders).reshape(n, k_ang)
    patch = torch.cat(patches).reshape(n, k_ang, 3, 3)
    imax = torch.argmax(v, dim=1)
    ar = torch.arange(n, device=dev)
    best_v = v[ar, imax]
    best_xy = xy[ar, imax].to(torch.float32)
    best_ang = angs[ar, imax]
    if cfg["use_subpixel"] and l == 0 and k_ang == 3:
        sub = ops.subpixel(patch, step * geo.D2R)
        gate = (imax == 1) & ~border[ar, imax]
        best_xy = torch.where(gate[:, None], best_xy + sub[:, :2], best_xy)
        best_ang = torch.where(gate, best_ang + sub[:, 2] * f32(geo.R2D),
                               best_ang)
    pad_lt = ops.rotate_pt(p2, center_t, best_ang * f32(geo.D2R)) - 3.0
    pt = ops.rotate_pt(best_xy + pad_lt, center_t, -best_ang * f32(geo.D2R))
    return pt, best_ang, best_v


def answer(frame_u8: np.ndarray, templ_u8: np.ndarray, config: dict,
           device, work=None, score_dtype="float32") -> np.ndarray:
    """The reference's answer for one frame of a configuration: its match
    list (see `match`). score_dtype names a torch dtype; a configuration's
    control passes a lower one."""
    return match(frame_u8, templ_u8, config["match"], device,
                 getattr(torch, score_dtype), work)


def match(frame_u8: np.ndarray, templ_u8: np.ndarray, cfg: dict, device,
          score_dtype=torch.float32, work=None) -> np.ndarray:
    """The matches of one template in one frame, best first: an [n, 4] f64
    array of (score, angle deg, centre x, centre y), n <= max_pos.

    cfg: the match settings of SETTINGS. score_dtype: the precision the
    NCC scores are kept in (float32; the control passes a lower one).
    work: a list that collects the device work (see the module's note).
    TF32 stays off in f32 matmuls and convolutions, as exact f32 sums
    need."""
    _check_settings(cfg)
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _match(frame_u8, templ_u8, cfg, torch.device(device),
                      score_dtype, work)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _match(frame_u8, templ_u8, cfg, dev, score_dtype, work):
    templs, stats, border = learn(templ_u8, cfg["min_reduce_area"], dev)
    top = len(templs) - 1
    shapes = [tuple(t.shape) for t in templs]
    src = torch.as_tensor(np.ascontiguousarray(frame_u8), device=dev).to(
        torch.float32)
    pyr = ops.pyramid(src, top)
    src_sizes = [tuple(p.shape) for p in pyr]

    angles = geo.angle_schedule(shapes[top], cfg["tolerance_angle"])
    sh_t, sw_t = src_sizes[top]
    th_t, tw_t = shapes[top]
    best = [geo.best_rotation_size((sw_t, sh_t), (tw_t, th_t), a)
            for a in angles]
    plan = {"angles": angles,
            "canvas_hw": (max(max(b[1] for b in best), th_t),
                          max(max(b[0] for b in best), tw_t)),
            "k": cfg["max_pos"] + MATCH_CANDIDATE_NUM}
    layer_scores = [cfg["score"]]
    for _ in range(top):
        layer_scores.append(layer_scores[-1] * 0.9)
    thr_t = torch.tensor(layer_scores, dtype=torch.float32, device=dev)
    k_ang = 1 if cfg["tolerance_angle"] < geo.VISION_TOLERANCE else 3

    vals, locs, trans, angles_arr = _sweep(
        pyr[top], templs[top], stats[top], cfg, plan, border, score_dtype,
        work)
    K = plan["k"]
    C = min(MAX_CANDIDATES, len(angles) * K)
    flat_v = vals.reshape(-1)
    masked = torch.where(flat_v >= thr_t[top], flat_v, -1.0)
    idx = torch.sort(masked, descending=True, stable=True).indices[:C]
    live = masked[idx] >= thr_t[top]
    idx = idx[live]
    aidx = idx // K
    pt = locs.reshape(-1, 2)[idx].to(torch.float32) - trans[aidx]
    ang = angles_arr[aidx]
    score = masked[idx]
    center_top = torch.tensor([(sw_t - 1) / 2.0, (sh_t - 1) / 2.0],
                              dtype=torch.float32, device=dev)
    pt = ops.rotate_pt(pt, center_top, -ang * f32(geo.D2R))

    for l in range(top - 1, -1, -1):
        if pt.shape[0] == 0:
            break
        pt, ang, score = _descend_level(l, pyr[l], templs[l], stats[l], pt,
                                        ang, k_ang, cfg, score_dtype, work)
        keep = score >= thr_t[l]
        pt, ang, score = pt[keep], ang[keep], score[keep]

    ok = score >= thr_t[0]
    pt, ang, score = pt[ok], ang[ok], score[ok]
    order = _lexsort((ang, pt[:, 0], pt[:, 1], -score))
    pt, ang, score = pt[order], ang[order], score[order]
    h0, w0 = shapes[0]
    quads = ops.rect_corners(pt, ang, float(w0), float(h0))
    keep = torch.as_tensor(ops.overlap_keep(quads, float(w0 * h0),
                                            cfg["max_overlap"]), device=dev)
    pt, ang, score = (x[keep][:cfg["max_pos"]] for x in (pt, ang, score))
    corners = ops.rect_corners(pt, ang, float(w0), float(h0))
    centre = torch.mean(corners, dim=-2)
    out_ang = -ang
    out_ang = torch.where(out_ang < -180.0, out_ang + 360.0, out_ang)
    out_ang = torch.where(out_ang > 180.0, out_ang - 360.0, out_ang)
    return torch.stack([score, out_ang, centre[:, 0], centre[:, 1]],
                       -1).cpu().numpy().astype(np.float64)
