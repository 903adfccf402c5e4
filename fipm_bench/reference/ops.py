"""The plain operations of the reference matcher, in PyTorch and numpy.

A frozen copy of the plain (non-kernel) path of the port's `ops/`
modules, cut to what one frame needs: cv::pyrDown, the bilinear affine
warp, the centred-u8 NCC score map with exact f64 correlations, greedy
masked peaks, the rotated-rect overlap filter as a sequential greedy, and
the quadratic subpixel fit. It imports nothing of the port and no
hand-written kernel: every warp is a gather and every correlation an f64
convolution or matmul, rounded to f32 once, so integer inputs give exact
sums on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FLT_EPSILON = np.float32(1.1920929e-07)


def f32(x) -> float:
    """The f32 rounding of x as a Python float."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """f32 a*b + c rounded once (evaluated in f64)."""
    def d(x):
        return x.to(torch.float64) if torch.is_tensor(x) else float(x)
    return (d(a) * d(b) + d(c)).to(torch.float32)


def cos_sin(x: torch.Tensor):
    """f32 cosine and sine of an f32 tensor, evaluated in f64."""
    xd = x.to(torch.float64)
    return torch.cos(xd).to(torch.float32), torch.sin(xd).to(torch.float32)


# ---------------------------------------------------------------- pyramid

_K1 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
_K2 = np.outer(_K1, _K1)  # sums to 256


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown of a u8-valued f32 image [h, w]: the 5x5 binomial blur
    under BORDER_REFLECT_101, every second sample, (sum + 128) >> 8."""
    h, w = img.shape
    ry = torch.as_tensor(np.pad(np.arange(h), 2, mode="reflect"),
                         device=img.device)
    rx = torch.as_tensor(np.pad(np.arange(w), 2, mode="reflect"),
                         device=img.device)
    x = img.index_select(0, ry).index_select(1, rx)
    k = torch.as_tensor(_K2, device=img.device)[None, None]
    out = F.conv2d(x[None, None], k, stride=2)[0, 0]
    return torch.floor((out + 128.0) / 256.0)


def pyramid(img: torch.Tensor, levels: int):
    out = [img.to(torch.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return out


# ------------------------------------------------------------------- warp

def warp(src: torch.Tensor, inv_mats: torch.Tensor, out_hw, border: float,
         quantize: bool = True) -> torch.Tensor:
    """Bilinear samples of src [H, W] at A inverse affine maps [A, 2, 3]
    (dst -> src) -> [A, Ho, Wo]; BORDER_CONSTANT; rounded half to even
    when `quantize` (the reference tool's u8 warped images)."""
    H, W = src.shape
    Ho, Wo = out_hw
    dev = src.device
    xs = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :].expand(
        Ho, Wo)
    ys = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None].expand(
        Ho, Wo)
    m = [inv_mats[:, r, c][:, None, None] for r in (0, 1) for c in (0, 1, 2)]
    fx = fma(m[0], xs, m[1] * ys) + m[2]
    fy = fma(m[3], xs, m[4] * ys) + m[5]
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - x0f, fy - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    flat = src.reshape(-1)
    bval = f32(border)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(inb, v, bval)

    out = fma((1 - ax) * (1 - ay), tap(y0, x0),
              ax * (1 - ay) * tap(y0, x0 + 1))
    out = fma((1 - ax) * ay, tap(y0 + 1, x0), out)
    out = fma(ax * ay, tap(y0 + 1, x0 + 1), out)
    return torch.round(out) if quantize else out


def rotate_pt(pt: torch.Tensor, org, angle_rad) -> torch.Tensor:
    """Rotate pt [..., 2] about org by angle_rad (image coordinates)."""
    org = torch.as_tensor(org, dtype=torch.float32, device=pt.device)
    c, s = cos_sin(torch.as_tensor(angle_rad, dtype=torch.float32,
                                   device=pt.device))
    dx = pt[..., 0] - org[..., 0]
    dy = pt[..., 1] - org[..., 1]
    x = fma(dy, s, fma(dx, c, org[..., 0]))
    y = fma(dy, c, fma(-dx, s, org[..., 1]))
    return torch.stack([x, y], dim=-1)


def rotation_invmaps(center_xy, angles_deg: torch.Tensor,
                     shift_xy: torch.Tensor) -> torch.Tensor:
    """Inverse maps [N, 2, 3] of 'rotate about center by angle, then
    translate by shift'."""
    cx, cy = (f32(v) for v in center_xy)
    ca, sa = cos_sin(angles_deg * f32(math.pi / 180.0))
    sx, sy = shift_xy[..., 0], shift_xy[..., 1]
    tx = fma(sa, sy + cy, fma(-ca, sx + cx, cx))
    ty = fma(-ca, sy + cy, fma(-sa, sx + cx, cy))
    return torch.stack([torch.stack([ca, -sa, tx], -1),
                        torch.stack([sa, ca, ty], -1)], -2)


# -------------------------------------------------------------------- NCC

def _window_sum_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    c = torch.cumsum(x.to(torch.float64), dim=dim)
    c = F.pad(c.movedim(dim, -1), (1, 0)).movedim(-1, dim)
    n = x.shape[dim]
    return c.narrow(dim, k, n - k + 1) - c.narrow(dim, 0, n - k + 1)


def window_sums(x: torch.Tensor, hw) -> torch.Tensor:
    """Exact valid-mode window sums over the last two dims, as f32."""
    y = _window_sum_1d(x, hw[0], x.ndim - 2)
    return _window_sum_1d(y, hw[1], x.ndim - 1).to(torch.float32)


def ccorr(canv_c: torch.Tensor, templ_c: torch.Tensor) -> torch.Tensor:
    """Valid-mode raw correlation [B, H, W] x [h, w] in f64, rounded to
    f32 once: exact on integer inputs. A matmul against the shifted
    template copies for small outputs, a convolution otherwise."""
    B, H, W = canv_c.shape
    h, w = templ_c.shape
    Ho, Wo = H - h + 1, W - w + 1
    if Ho * Wo > 512:
        return F.conv2d(canv_c.to(torch.float64)[:, None],
                        templ_c.to(torch.float64)[None, None])[:, 0].to(
                            torch.float32)
    tsh = canv_c.new_zeros((Ho * Wo, H, W), dtype=torch.float64)
    for dy in range(Ho):
        for dx in range(Wo):
            tsh[dy * Wo + dx, dy:dy + h, dx:dx + w] = templ_c
    out = canv_c.reshape(B, H * W).to(torch.float64) @ tsh.reshape(
        Ho * Wo, H * W).T
    return out.reshape(B, Ho, Wo).to(torch.float32)


def ncc_map(canv: torch.Tensor, templ: torch.Tensor, stats,
            score_dtype=torch.float32) -> torch.Tensor:
    """TM_CCOEFF_NORMED scores [B, Ho, Wo] of u8-valued canvases against
    one template, with the reference tool's flat-template shortcut and its
    epsilon / 1.125 guards. stats: (mean, norm, inv_area, equal1).
    score_dtype: the precision the scores are kept in (float32; the
    control keeps them in a lower one)."""
    mean, norm, inv_area, equal1 = stats
    h, w = templ.shape
    B, H, W = canv.shape
    if equal1:
        return canv.new_ones((B, H - h + 1, W - w + 1))
    area = float(h * w)
    sc = canv - 128.0
    cc = ccorr(sc, templ - 128.0)
    s1 = window_sums(sc, (h, w))
    s2 = window_sums(sc * sc, (h, w))
    num = fma(s1, f32(128.0 - f32(mean)), cc)
    wnd_sum2 = s2 + 256.0 * s1 + f32(16384.0 * area)
    diff2 = torch.clamp_min(fma(-(s1 * s1), f32(inv_area), s2), 0.0)
    cutoff = torch.clamp_max(f32(10.0 * FLT_EPSILON) * wnd_sum2, 0.5)
    t = torch.where(diff2 <= cutoff, 0.0, torch.sqrt(diff2) * f32(norm))
    num_abs = torch.abs(num)
    out = torch.where(num_abs < t, num / torch.clamp_min(t, f32(1e-30)),
                      torch.where(num_abs < t * 1.125, torch.sign(num), 0.0))
    if score_dtype != torch.float32:
        out = out.to(score_dtype).to(torch.float32)
    return out


# ------------------------------------------------------------------ peaks

def peaks(scores: torch.Tensor, k: int, templ_wh, max_overlap: float):
    """Greedy masked top-k per map [A, Hs, Ws]: k rounds of first-max
    argmax, each painting its suppression rectangle with -1. Returns
    (vals [A, k], locs [A, k, 2] int32 as (x, y))."""
    A, Hs, Ws = scores.shape
    tw, th = templ_wh
    sw = int(2 * tw * (1 - max_overlap))
    sh = int(2 * th * (1 - max_overlap))
    off_x = f32(tw * (1.0 - max_overlap))
    off_y = f32(th * (1.0 - max_overlap))
    dev = scores.device
    xs = torch.arange(Ws, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=torch.int32, device=dev)[None, :, None]
    maps = scores.clone()
    flat = maps.view(A, Hs * Ws)
    rows = torch.arange(A, device=dev)
    vals, locs = [], []
    for _ in range(k):
        idx = torch.argmax(flat, dim=1)
        vals.append(flat[rows, idx])
        y = (idx // Ws).to(torch.int32)
        x = (idx % Ws).to(torch.int32)
        locs.append(torch.stack([x, y], dim=-1))
        x0 = torch.trunc(x.to(torch.float32) - off_x).to(torch.int32)
        y0 = torch.trunc(y.to(torch.float32) - off_y).to(torch.int32)
        x0, y0 = x0[:, None, None], y0[:, None, None]
        maps.masked_fill_((xs >= x0) & (xs <= x0 + sw - 1)
                          & (ys >= y0) & (ys <= y0 + sh - 1), -1.0)
    return torch.stack(vals, dim=1), torch.stack(locs, dim=1)


# -------------------------------------------------------------------- NMS

def rect_corners(pt_lt: torch.Tensor, angle_deg: torch.Tensor, w: float,
                 h: float) -> torch.Tensor:
    """Corners [..., 4, 2] (LT, RT, RB, LB) of the rect at LT rotated by
    -angle about LT."""
    cosr, sinr = cos_sin(-angle_deg * f32(math.pi / 180.0))
    w, h = f32(w), f32(h)
    lt = pt_lt
    rt = torch.stack([lt[..., 0] + w * cosr, lt[..., 1] - w * sinr], -1)
    lb = torch.stack([lt[..., 0] + h * sinr, lt[..., 1] + h * cosr], -1)
    rb = torch.stack([rt[..., 0] + h * sinr, rt[..., 1] + h * cosr], -1)
    return torch.stack([lt, rt, rb, lb], dim=-2)


def _clip(pts, cnt, a, b):
    """Sutherland-Hodgman: polygons pts [P, 8, 2] (cnt vertices) clipped
    by the half-plane left of a->b."""
    P, n, _ = pts.shape
    idx = torch.arange(n, device=pts.device)[None, :]
    succ = torch.where(idx + 1 >= cnt[:, None], 0, idx + 1)
    nxt = torch.gather(pts, 1, succ[..., None].expand(P, n, 2))
    ex = (b[:, 0] - a[:, 0])[:, None]
    ey = (b[:, 1] - a[:, 1])[:, None]

    def side(p):
        return ex * (p[..., 1] - a[:, 1:2]) - ey * (p[..., 0] - a[:, 0:1])

    s_cur, s_nxt = side(pts), side(nxt)
    in_cur = s_cur >= 0
    crosses = in_cur != (s_nxt >= 0)
    denom = s_cur - s_nxt
    big = torch.abs(denom) > 1e-12
    tpar = torch.where(big, s_cur / torch.where(big, denom, 1.0), 0.0)
    inter = pts + tpar[..., None] * (nxt - pts)
    valid = idx < cnt[:, None]
    emit_cur = in_cur & valid
    emit_int = crosses & valid
    counts = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    pos_cur = torch.cumsum(counts, dim=1) - counts
    pos_int = pos_cur + emit_cur.to(torch.int64)
    pos_cur = torch.where(emit_cur & (pos_cur < n), pos_cur, n)
    pos_int = torch.where(emit_int & (pos_int < n), pos_int, n)
    out = pts.new_zeros((P, n + 1, 2))
    out.scatter_(1, pos_cur[..., None].expand(P, n, 2), pts)
    out.scatter_(1, pos_int[..., None].expand(P, n, 2), inter)
    return out[:, :n], torch.clamp_max(counts.sum(dim=1), n)


def quad_area(quad_a: torch.Tensor, quad_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas [P] of convex quads [P, 4, 2]."""
    P = quad_a.shape[0]
    pts = quad_a.new_zeros((P, 8, 2))
    pts[:, :4] = quad_a
    cnt = torch.full((P,), 4, dtype=torch.int64, device=quad_a.device)
    for k in range(4):
        pts, cnt = _clip(pts, cnt, quad_b[:, k], quad_b[:, (k + 1) % 4])
    idx = torch.arange(8, device=pts.device)[None, :]
    succ = torch.where(idx + 1 >= cnt[:, None], 0, idx + 1)
    nxt = torch.gather(pts, 1, succ[..., None].expand(P, 8, 2))
    cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
    cross = torch.where(idx < cnt[:, None], cross, 0.0)
    area = 0.5 * torch.abs(cross.sum(dim=1))
    return torch.where(cnt >= 3, area, 0.0)


def overlap_keep(quads: torch.Tensor, templ_area: float,
                 max_overlap: float) -> np.ndarray:
    """The reference tool's FilterWithRotatedRect over score-sorted quads
    [n, 4, 2]: walking in order, each survivor deletes every later quad
    that it contains or overlaps by more than max_overlap of the template
    area. Returns the keep mask [n]."""
    n = quads.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    qa = quads[:, None].expand(n, n, 4, 2).reshape(n * n, 4, 2)
    qb = quads[None].expand(n, n, 4, 2).reshape(n * n, 4, 2)
    pair = quad_area(qa, qb).reshape(n, n)
    contain = pair >= f32(templ_area * (1.0 - 1e-6))
    conflict = (contain | (pair / f32(templ_area) > f32(max_overlap))
                ).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            later = np.arange(n) > i
            keep &= ~(conflict[i] & later)
    return keep


# --------------------------------------------------------------- subpixel

def _design_pinv() -> np.ndarray:
    rows = []
    for t in (-1.0, 0.0, 1.0):
        for y in (-1.0, 0.0, 1.0):
            for x in (-1.0, 0.0, 1.0):
                rows.append([x * x, y * y, t * t, x * y, x * t, y * t,
                             x, y, t, 1.0])
    return np.linalg.pinv(np.array(rows, np.float64))


_PINV = _design_pinv().astype(np.float32)


def subpixel(patches: torch.Tensor, step_rad: float) -> torch.Tensor:
    """Stationary point (dx, dy, dtheta_rad) [n, 3] of the quadratic
    fitted to score patches [n, 3, 3, 3] (theta, dy, dx)."""
    s = patches.reshape(patches.shape[0], 27)
    pinv = torch.as_tensor(_PINV, device=patches.device).to(torch.float64)
    z = (s.to(torch.float64) @ pinv.T).to(torch.float32)
    k0, k1, k2, k3, k4, k5, k6, k7, k8 = (z[:, i] for i in range(9))
    a, b, c = 2 * k0, k3, k4
    d_, e, f = k3, 2 * k1, k5
    g, h, i = k4, k5, 2 * k2
    det = a * (e * i - f * h) - b * (d_ * i - f * g) + c * (d_ * h - e * g)
    safe = torch.abs(det) > 1e-20
    det = torch.where(safe, det, 1.0)
    r0, r1, r2 = -k6, -k7, -k8
    dx = (r0 * (e * i - f * h) - b * (r1 * i - f * r2)
          + c * (r1 * h - e * r2)) / det
    dy = (a * (r1 * i - f * r2) - r0 * (d_ * i - f * g)
          + c * (d_ * r2 - r1 * g)) / det
    dt = (a * (e * r2 - r1 * h) - b * (d_ * r2 - r1 * g)
          + r0 * (d_ * h - e * g)) / det
    zero = torch.zeros_like(dx)
    return torch.stack([torch.where(safe, dx, zero),
                        torch.where(safe, dy, zero),
                        torch.where(safe, dt, zero) * f32(step_rad)], -1)
