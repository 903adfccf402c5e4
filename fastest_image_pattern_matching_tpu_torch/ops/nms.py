"""Rotated-rectangle overlap filtering (NMS).

Reference: FilterWithRotatedRect (MatchTool/MatchToolDlg.cpp:1498-1557)
walks score-sorted candidates pairwise and deletes the lower-scored one of
a pair when it is fully contained or when intersection_area /
template_area > max_overlap.

Pair areas come from a batched Sutherland-Hodgman clip (convex quad by
convex quad, at most 8 vertices) with plain gathers and scatters, computed
only among the valid candidates. The greedy order is then applied in rounds:
each round decides every candidate whose earlier conflicters are all
decided, which reproduces the sequential greedy result exactly.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span
from .rounding import cos_sin, f32

# Clipping a convex polygon by a half-plane adds at most one vertex, so a
# quad clipped by 4 half-planes has at most 8.
_MAXV = 8

# Rows of the pair-area matrix computed per step (bounds the [rows * n, 8]
# clip buffers).
_ROW_CHUNK = 64


def _clip_halfplane(pts, cnt, a, b):
    """Clip polygons pts [P, N, 2] (cnt [P] valid vertices) by the
    half-plane left of a->b ([P, 2] each). Returns (pts', cnt'), with the
    count clamped to the buffer size N."""
    P, n, _ = pts.shape
    idx = torch.arange(n, device=pts.device)[None, :]
    succ = torch.where(idx + 1 >= cnt[:, None], 0, idx + 1)
    nxt = torch.gather(pts, 1, succ[..., None].expand(P, n, 2))

    ex = (b[:, 0] - a[:, 0])[:, None]
    ey = (b[:, 1] - a[:, 1])[:, None]
    ax_, ay_ = a[:, 0:1], a[:, 1:2]

    def side(p):
        # cross(b-a, p-a); >= 0 is inside for LT,RT,RB,LB winding in image
        # coords (y down).
        return ex * (p[..., 1] - ay_) - ey * (p[..., 0] - ax_)

    s_cur = side(pts)
    s_nxt = side(nxt)
    in_cur = s_cur >= 0
    crosses = in_cur != (s_nxt >= 0)

    denom = s_cur - s_nxt
    big = torch.abs(denom) > 1e-12
    tparam = torch.where(big, s_cur / torch.where(big, denom, 1.0), 0.0)
    inter = pts + tparam[..., None] * (nxt - pts)

    valid = idx < cnt[:, None]
    emit_cur = in_cur & valid
    emit_int = crosses & valid
    counts = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    pos_cur = torch.cumsum(counts, dim=1) - counts  # exclusive
    pos_int = pos_cur + emit_cur.to(torch.int64)
    # Unemitted entries (and any past the buffer) go to a dump slot n.
    pos_cur = torch.where(emit_cur & (pos_cur < n), pos_cur, n)
    pos_int = torch.where(emit_int & (pos_int < n), pos_int, n)
    out = pts.new_zeros((P, n + 1, 2))
    out.scatter_(1, pos_cur[..., None].expand(P, n, 2), pts)
    out.scatter_(1, pos_int[..., None].expand(P, n, 2), inter)
    return out[:, :n], torch.clamp_max(counts.sum(dim=1), n)


def quad_intersection_area(quad_a: torch.Tensor, quad_b: torch.Tensor
                           ) -> torch.Tensor:
    """Intersection areas [P] of convex quads [P, 4, 2] given in the same
    winding (LT, RT, RB, LB in image coords): quad_a clipped by quad_b."""
    P = quad_a.shape[0]
    pts = quad_a.new_zeros((P, _MAXV, 2))
    pts[:, :4] = quad_a
    cnt = torch.full((P,), 4, dtype=torch.int64, device=quad_a.device)
    for k in range(4):
        with span("fipm.nms.clip"):
            pts, cnt = _clip_halfplane(pts, cnt, quad_b[:, k],
                                       quad_b[:, (k + 1) % 4])
    idx = torch.arange(_MAXV, device=pts.device)[None, :]
    succ = torch.where(idx + 1 >= cnt[:, None], 0, idx + 1)
    nxt = torch.gather(pts, 1, succ[..., None].expand(P, _MAXV, 2))
    cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
    cross = torch.where(idx < cnt[:, None], cross, 0.0)
    area = 0.5 * torch.abs(cross.sum(dim=1))
    return torch.where(cnt >= 3, area, 0.0)


def rotated_rect_corners(pt_lt: torch.Tensor, angle_deg: torch.Tensor,
                         w: float, h: float) -> torch.Tensor:
    """Corners [..., 4, 2] (LT, RT, RB, LB) of the matched rect, the
    reference construction (MatchToolDlg.cpp:1058-1063): rotate by
    -angle about LT in image coords."""
    cosr, sinr = cos_sin(-angle_deg * f32(math.pi / 180.0))
    w, h = f32(w), f32(h)
    lt = pt_lt
    rt = torch.stack([lt[..., 0] + w * cosr, lt[..., 1] - w * sinr], dim=-1)
    lb = torch.stack([lt[..., 0] + h * sinr, lt[..., 1] + h * cosr], dim=-1)
    rb = torch.stack([rt[..., 0] + h * sinr, rt[..., 1] + h * cosr], dim=-1)
    return torch.stack([lt, rt, rb, lb], dim=-2)


def filter_overlaps(
    quads: torch.Tensor,    # [C, 4, 2] or [N, C, 4, 2], each row score-sorted
    valid: torch.Tensor,    # [C] or [N, C] bool
    templ_area: float,
    max_overlap: float,
) -> torch.Tensor:
    """Greedy suppression; returns the surviving-candidate mask [C] (or
    [N, C]: each of N frames on its own).

    For each surviving i in score order, every later j of the same frame
    whose intersection with i is full containment or has area ratio (vs
    the template area) > max_overlap is deleted. An invalid candidate
    never survives and never deletes, so pair areas are computed among the
    valid ones of each frame only (one host sync to count them), and the
    greedy rounds run for all frames at once (one host sync a round).
    f32 quads compare in f32 like the JAX package; f64 quads (the
    cross-template NMS of models/multi_template.py) in f64 like the C++
    greedy of the JAX package's native library.
    """
    if quads.ndim == 3:
        return filter_overlaps(quads[None], valid[None], templ_area,
                               max_overlap)[0]
    N, C = valid.shape
    dev = quads.device
    keep = torch.zeros((N, C), dtype=torch.bool, device=dev)
    n_valid = valid.sum(dim=1)
    n = int(n_valid.max()) if N else 0
    if n == 0:
        return keep
    # The valid candidates of each frame first, in order; slots past a
    # frame's count hold invalid ones and take no part.
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True
                       ).indices[:, :n]
    slot = torch.arange(n, device=dev)
    used = slot[None, :] < n_valid[:, None]
    q = torch.gather(quads, 1, order[:, :, None, None].expand(N, n, 4, 2))
    rows = []
    for lo in range(0, n, _ROW_CHUNK):
        with span("fipm.nms.area"):
            qa = q[:, lo:lo + _ROW_CHUNK]
            r = qa.shape[1]
            qa_p = qa[:, :, None].expand(N, r, n, 4, 2).reshape(
                N * r * n, 4, 2)
            qb_p = q[:, None].expand(N, r, n, 4, 2).reshape(N * r * n, 4, 2)
            rows.append(quad_intersection_area(qa_p, qb_p).reshape(N, r, n))
    with span("fipm.nms.greedy"):
        return _greedy(torch.cat(rows, dim=1), quads.dtype, templ_area,
                       max_overlap, slot, used, order, keep)


def _greedy(pair_area, dtype, templ_area, max_overlap, slot, used, order,
            keep):
    """filter_overlaps' greedy rounds over the pair areas [f, i, j] (quad
    i clipped by quad j) of the valid candidates in slot order; fills and
    returns keep."""
    rnd = f32 if dtype == torch.float32 else float
    contain = pair_area >= rnd(templ_area * (1.0 - 1e-6))
    conflict = contain | (pair_area / rnd(templ_area) > rnd(max_overlap))

    # [f, i, j]: i kills j
    earlier = (conflict & (slot[:, None] < slot[None, :])
               & used[:, :, None] & used[:, None, :])
    decided = ~used
    alive = used.clone()
    # Each round decides at least the first undecided candidate of every
    # frame; in practice the loop ends in the conflict-chain depth (2-5
    # rounds).
    while not bool(decided.all()):
        ready = torch.all(~earlier | decided[:, :, None], dim=1)
        killed = torch.any(earlier & (alive & decided)[:, :, None], dim=1)
        alive = torch.where(ready & ~decided, ~killed, alive)
        decided = decided | ready
    keep.scatter_(1, order, alive)
    return keep
