"""Fused normalized cross-correlation (TM_CCOEFF_NORMED) score maps.

Reference pipeline per rotated canvas: raw TM_CCORR followed by
CCOEFF_Denominator (integral-image window stats + numeric guards,
MatchTool/MatchToolDlg.cpp:1275-1400).

The centred-u8 scheme of the JAX package: with Sc = S - 128 and
Tc = T - 128 (both integers in [-128, 127] for u8-valued input) and
T_bar = mean(T),

    num   = ccorr_c + (128 - T_bar) * s1c      ccorr_c = corr(Sc, Tc)
    diff2 = s2c - s1c^2 / area                 s1c, s2c = window sums of
                                                Sc and Sc^2
    score = num / (sqrt(diff2) * templNorm), with the reference's
            rounding-error cutoff and the 1.125 clamp band.

The correlations run in f32 (TF32 off): F.conv2d for the top-layer map and
one matmul against all shifted template copies for the 7x7 descent maps.
Both are exact while every partial sum stays below 2^24, which holds for
the top layer (9*12*128^2 < 2^24 on the flagship).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rounding import f32, fma

FLT_EPSILON = np.float32(1.1920929e-07)

# The Pallas tiled-band correlation kernel's eligibility
# (fastest_image_pattern_matching_tpu/ops/pallas/corr_kernel.py:78-83) and
# the map size above which the JAX package routes to it (ops/ncc.py:262).
_TILEDBAND_MIN_OUT = 65536
_TILEDBAND_MAX_W = 129
_TILEDBAND_MAX_H = 64


def _tiledband_eligible(h: int, w: int) -> bool:
    return 2 <= w <= _TILEDBAND_MAX_W and 1 <= h <= _TILEDBAND_MAX_H


def _window_sum_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Valid-mode sums of k consecutive entries along `dim`, as an f64
    prefix-sum difference. For f32 input of magnitude <= 2^14 (the centred
    u8 values and their squares) over up to 2^22 terms the f64 sums are
    exact, so the result does not depend on summation order or device."""
    c = torch.cumsum(x.to(torch.float64), dim=dim)
    c = F.pad(c.movedim(dim, -1), (1, 0)).movedim(-1, dim)
    n = x.shape[dim]
    return c.narrow(dim, k, n - k + 1) - c.narrow(dim, 0, n - k + 1)


def window_sums(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Valid-mode sliding-window sums over the last two dims, rows first,
    then columns: [..., H, W] -> [..., H-h+1, W-w+1] f32 (the exact sum,
    rounded once)."""
    h, w = hw
    y = _window_sum_1d(x, h, x.ndim - 2)
    return _window_sum_1d(y, w, x.ndim - 1).to(torch.float32)


def ccorr_conv(canvases_c: torch.Tensor, templ_c: torch.Tensor
               ) -> torch.Tensor:
    """Raw centred cross-correlation [B, H, W] x [h, w] -> [B, Ho, Wo] f32
    as one f32 convolution."""
    return F.conv2d(canvases_c[:, None], templ_c[None, None])[:, 0]


def ccorr_shiftmm(canvases_c: torch.Tensor, templ_c: torch.Tensor
                  ) -> torch.Tensor:
    """Centred cross-correlation for small output grids as one matmul:
    score[b, s] = <roi[b], template shifted by s>, over all Ho*Wo shifts."""
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    Ho, Wo = H - h + 1, W - w + 1
    tsh = canvases_c.new_zeros((Ho * Wo, H, W))
    for dy in range(Ho):
        for dx in range(Wo):
            tsh[dy * Wo + dx, dy:dy + h, dx:dx + w] = templ_c
    out = torch.matmul(canvases_c.reshape(B, H * W),
                       tsh.reshape(Ho * Wo, H * W).T)
    return out.reshape(B, Ho, Wo)


def ncc_score_map(
    canvases: torch.Tensor,     # [B, H, W] f32 (u8-valued)
    templ: torch.Tensor,        # [h, w] f32 (u8-valued)
    templ_mean: float,          # host-precomputed f64 scalar (meanStdDev)
    templ_norm: float,          # sigma * sqrt(area)
    inv_area: float,
    result_equal1: bool,
    method: str = "auto",
) -> torch.Tensor:
    """Fused TM_CCORR + CCOEFF_Denominator -> [B, Ho, Wo] f32 scores,
    including the flat-template all-ones shortcut (MatchToolDlg.cpp:
    1331-1335) and the epsilon / 1.125 guards (:1384-1395).

    method: "conv", "shiftmm" or "auto" (shiftmm when Ho*Wo <= 512, else
    conv). Where the JAX package would take its Pallas tiled-band kernel
    (Ho*Wo > 65536 with an eligible template), CUDA tensors raise until that
    kernel is ported; CPU tensors take the conv.
    """
    h, w = templ.shape
    B, H, W = canvases.shape
    Ho, Wo = H - h + 1, W - w + 1
    if result_equal1:
        return canvases.new_ones((B, Ho, Wo))

    area = float(h * w)
    sc = canvases - 128.0
    tc = templ - 128.0

    if method == "auto":
        if Ho * Wo <= 512:
            method = "shiftmm"
        else:
            if (Ho * Wo > _TILEDBAND_MIN_OUT and _tiledband_eligible(h, w)
                    and canvases.is_cuda):
                raise NotImplementedError(
                    "large score maps with small templates need the Hopper "
                    "correlation kernel (ROADMAP.md, TPU kernels to port: "
                    "ccorr_tiledband_pallas), which is not ported yet")
            method = "conv"
    if method == "shiftmm":
        ccorr_c = ccorr_shiftmm(sc, tc)
    elif method == "conv":
        ccorr_c = ccorr_conv(sc, tc)
    else:
        raise ValueError(f"unknown correlation method {method!r} "
                         "(expected auto|conv|shiftmm)")
    s1c = window_sums(sc, (h, w))
    s2c = window_sums(sc * sc, (h, w))

    # Both sums are single-rounding multiply-adds: the cancellation in
    # diff2 = s2c - s1c^2/area is the epilogue's most fragile step, and
    # this is also the form the JAX package compiles to on the CPU.
    num = fma(s1c, f32(128.0 - f32(templ_mean)), ccorr_c)
    wnd_sum2 = s2c + 256.0 * s1c + f32(16384.0 * area)
    diff2 = torch.clamp_min(fma(-(s1c * s1c), f32(inv_area), s2c), 0.0)

    cutoff = torch.clamp_max(f32(10.0 * FLT_EPSILON) * wnd_sum2, 0.5)
    t = torch.where(diff2 <= cutoff, 0.0,
                    torch.sqrt(diff2) * f32(templ_norm))

    num_abs = torch.abs(num)
    safe_t = torch.clamp_min(t, f32(1e-30))
    return torch.where(
        num_abs < t, num / safe_t,
        torch.where(num_abs < t * 1.125, torch.sign(num), 0.0))

