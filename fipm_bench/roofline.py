"""The least time one NVIDIA H100 could take for the algorithm's kernel
work, against NVIDIA's data-sheet peaks (SXM part, dense rates; the card's
power limit is printed beside every run, since a card set below 700 W
runs slower under load).

Each input byte is read once and each output byte written once, whatever
a kernel reads again; the operations are those the algorithm needs. The
work is counted from the shapes and maps that the plain reference warps
and correlates for the same frames, not from the port's launches, so any
kernel that does the same work is held to the same bound.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# f32 operations per warped pixel: two coordinates (fma, mul, add each),
# two floors and two fractions, two complements, four weights, the
# four-term blend and the rounding.
WARP_OPS_PER_PIXEL = 21


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the peak rate of their type, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def warp_source_pixels(src_hw, maps: torch.Tensor, out_hw) -> int:
    """Distinct source pixels that the bilinear taps of these inverse maps
    [B, 2, 3] read."""
    H, W = src_hw
    Ho, Wo = out_hw
    dev = maps.device
    y = torch.arange(Ho, device=dev, dtype=torch.float64)[:, None]
    x = torch.arange(Wo, device=dev, dtype=torch.float64)[None, :]
    seen = torch.zeros(H * W, dtype=torch.bool, device=dev)
    for m in maps.double():
        x0 = torch.floor(m[0, 0] * x + m[0, 1] * y + m[0, 2]).long()
        y0 = torch.floor(m[1, 0] * x + m[1, 1] * y + m[1, 2]).long()
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                seen[(yy * W + xx)[ok]] = True
    return int(seen.sum())


def warp_bound_s(src: torch.Tensor, maps: torch.Tensor, out_hw) -> float:
    """A batched f32 bilinear warp of B maps into [B, Ho, Wo]: the source
    pixels its taps read, its maps and its output; 21 f32 operations an
    output pixel."""
    B = maps.shape[0]
    n_out = B * out_hw[0] * out_hw[1]
    n_bytes = 4 * (warp_source_pixels(src.shape, maps, out_hw) + n_out
                   + 6 * B)
    return bound_s(n_bytes, WARP_OPS_PER_PIXEL * n_out, F32_OPS_PER_S)


def corr_bound_s(canv: torch.Tensor, templ: torch.Tensor) -> float:
    """A valid-mode correlation of canvases [B, H, W] with a template
    [h, w] into [B, Ho, Wo], f32 in and out: its multiply-adds at the int8
    tensor-core rate when both inputs are int8-valued (the centred u8
    values of the main path), at the f32 rate otherwise."""
    B, H, W = canv.shape
    h, w = templ.shape
    Ho, Wo = H - h + 1, W - w + 1
    n_bytes = 4 * (B * H * W + h * w + B * Ho * Wo)
    int8 = all(bool((t == t.round()).all()) and float(t.min()) >= -128
               and float(t.max()) <= 127 for t in (canv, templ))
    return bound_s(n_bytes, 2 * B * Ho * Wo * h * w,
                   INT8_OPS_PER_S if int8 else F32_OPS_PER_S)


def work_bounds(work) -> dict:
    """The least seconds of each kind of kernel work in a reference run's
    `work` list of (kind, seconds): {kind: s}."""
    out = {}
    for kind, secs in work:
        out[kind] = out.get(kind, 0.0) + secs
    return out
