"""Batched affine warps: the plain PyTorch bilinear gather and the dispatch
to the hand-written CUDA kernel.

The reference warps the source once per angle with cv::warpAffine
(INTER_LINEAR + BORDER_CONSTANT; MatchTool/MatchToolDlg.cpp:856 for the
top-layer canvas, :1327 for refinement ROIs). Here the per-angle loop is one
batched gather over an [A, Ho, Wo] grid. Coordinates use the inverse map
(dst -> src), which is what warpAffine computes from the forward matrix.

Every arithmetic step below is one f32 op in the order the JAX package
writes it. Multiply-adds are fused (rounded once) exactly where XLA's CPU
backend contracts the JAX reference into FMAs, and nowhere else: a
coordinate rounded differently can move floor() across an integer and flip
a quantized pixel. The CUDA kernel (csrc/warp_affine.cu) spells out the
same operations with explicit intrinsics, so plain version, kernel and the
JAX reference on the CPU agree bit for bit on the same maps.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .rounding import cos_sin, f32, fma


def warp_affine_batch(
    src: torch.Tensor,            # [H, W] or [N, H, W] f32
    inv_mats: torch.Tensor,       # [A, 2, 3] f32 (dst->src affine)
    out_hw: Tuple[int, int],
    border_value: float,
    quantize: bool = True,
    fixed_point_frac: bool = False,
    src_index: Optional[torch.Tensor] = None,   # [A] int, with [N, H, W]
) -> torch.Tensor:
    """Bilinear-sample `src` at A affine grids -> [A, Ho, Wo] f32.

    A stack of sources [N, H, W] needs `src_index`: map a samples source
    src_index[a]. `quantize` rounds to integers (half to even), emulating
    the reference's u8 warped mats. fixed_point_frac emulates OpenCV <=
    4.x's 10-bit fixed-point coordinate path (AB_BITS=10/INTER_BITS=5);
    the default uses exact float coordinates like OpenCV 5.
    """
    if (src.ndim == 3) != (src_index is not None):
        raise ValueError("a source stack [N, H, W] takes a src_index, a "
                         "single source [H, W] none")
    H, W = src.shape[-2:]
    Ho, Wo = out_hw
    dev = src.device
    xs = torch.arange(Wo, dtype=torch.float32, device=dev)[None, :].expand(
        Ho, Wo)
    ys = torch.arange(Ho, dtype=torch.float32, device=dev)[:, None].expand(
        Ho, Wo)

    a = inv_mats[:, 0, 0][:, None, None]
    b = inv_mats[:, 0, 1][:, None, None]
    tx = inv_mats[:, 0, 2][:, None, None]
    c = inv_mats[:, 1, 0][:, None, None]
    d = inv_mats[:, 1, 1][:, None, None]
    ty = inv_mats[:, 1, 2][:, None, None]

    if fixed_point_frac:
        # warpAffine's fixed-point coordinates: adelta[x] = rint(M00*x*1024),
        # per-row base = rint((M01*y+M02)*1024), X = (sum + 16) >> 5.
        xf = (torch.round(a * xs * 1024.0)
              + torch.round((b * ys + tx) * 1024.0) + 16.0)
        yf = (torch.round(c * xs * 1024.0)
              + torch.round((d * ys + ty) * 1024.0) + 16.0)
        x32 = torch.floor(xf / 32.0)
        y32 = torch.floor(yf / 32.0)
        x0f = torch.floor(x32 / 32.0)
        y0f = torch.floor(y32 / 32.0)
        ax = (x32 - x0f * 32.0) / 32.0
        ay = (y32 - y0f * 32.0) / 32.0
    else:
        fx = fma(a, xs, b * ys) + tx       # [A, Ho, Wo]
        fy = fma(c, xs, d * ys) + ty
        x0f = torch.floor(fx)
        y0f = torch.floor(fy)
        ax = fx - x0f
        ay = fy - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)

    border = f32(border_value)
    flat = src.reshape(-1)
    base = 0 if src_index is None else (
        src_index.to(torch.int64) * (H * W))[:, None, None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(inb, v, border)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)

    out = fma((1 - ax) * (1 - ay), v00, ax * (1 - ay) * v01)
    out = fma((1 - ax) * ay, v10, out)
    out = fma(ax * ay, v11, out)
    if quantize:
        out = torch.round(out)
    return out


def warp_affine_dispatch(
    src: torch.Tensor,
    inv_mats: torch.Tensor,
    out_hw: Tuple[int, int],
    border_value: float,
    quantize: bool = True,
    src_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The warp of the main path: the hand-written CUDA kernel for tensors
    on the card, the plain gather above for tensors on the CPU. Takes the
    arguments of warp_affine_batch; a stack of one source goes to the
    single-source form."""
    if src.ndim == 3 and src.shape[0] == 1 and src_index is not None:
        src, src_index = src[0], None
    if src.device.type == "cpu" and inv_mats.device.type == "cpu":
        return warp_affine_batch(src, inv_mats, out_hw, border_value,
                                 quantize=quantize, src_index=src_index)
    from .cuda.warp_kernel import warp_affine_cuda
    if src_index is None:
        return warp_affine_cuda(src, inv_mats, out_hw, float(border_value),
                                quantize)
    return warp_affine_cuda(src, inv_mats, out_hw, float(border_value),
                            quantize, src_index.to(torch.int32))


def rotate_pt(pt: torch.Tensor, org, angle_rad) -> torch.Tensor:
    """Rotate pt [..., 2] about org by angle_rad (ptRotatePt2f parity,
    MatchToolDlg.cpp:1469-1480), broadcasting over leading dims."""
    org = torch.as_tensor(org, dtype=torch.float32, device=pt.device)
    c, s = cos_sin(torch.as_tensor(angle_rad, dtype=torch.float32,
                                   device=pt.device))
    dx = pt[..., 0] - org[..., 0]
    dy = pt[..., 1] - org[..., 1]
    # x = ox + dx*c + dy*s and y = oy - dx*s + dy*c, as multiply-adds.
    x = fma(dy, s, fma(dx, c, org[..., 0]))
    y = fma(dy, c, fma(-dx, s, org[..., 1]))
    return torch.stack([x, y], dim=-1)


def make_rotation_invmaps(center_xy, angles_deg: torch.Tensor,
                          shift_xy: torch.Tensor) -> torch.Tensor:
    """Inverse (dst->src) affines [N, 2, 3] for the forward maps 'rotate
    about center by angle (getRotationMatrix2D convention), then translate
    by shift': p = rotate_pt(p' - shift, center, -angle_rad)."""
    cx, cy = (f32(v) for v in center_xy)
    ca, sa = cos_sin(angles_deg * f32(math.pi / 180.0))
    sx = shift_xy[..., 0]
    sy = shift_xy[..., 1]
    # tx = cx - ca*(sx+cx) + sa*(sy+cy), ty = cy - sa*(sx+cx) - ca*(sy+cy)
    tx = fma(sa, sy + cy, fma(-ca, sx + cx, cx))
    ty = fma(-ca, sy + cy, fma(-sa, sx + cx, cy))
    row0 = torch.stack([ca, -sa, tx], dim=-1)
    row1 = torch.stack([sa, ca, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)
