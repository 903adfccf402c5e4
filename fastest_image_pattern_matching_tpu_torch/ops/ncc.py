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

The raw correlation ccorr_c takes one of four routes, chosen by the JAX
package's rule (`ncc_score_map`, method "auto"), kept so that the port
takes the route JAX takes; its conv/fft crossover is the JAX package's
operation-count estimate, not a crossover measured on the card (PERF.md):
  * shiftmm: one f64 matmul against all shifted template copies, for the
    7x7 descent maps (Ho*Wo <= 512); on the card, the descent's integer
    ROIs skip it: descent_best (descent_best_stack for a stack of
    templates) sends them to the descent-score kernel
    (ops/cuda/descent_score_kernel.py), which scores them and picks each
    map's best in one launch;
  * tiled: large maps with small templates (Ho*Wo > 65536, 2 <= w <= 129,
    h <= 64), where the JAX package runs its Pallas tiled-band kernel. CUDA
    tensors launch the hand-written kernel (ops/cuda/corr_kernel.py), CPU
    tensors its plain version, the f64 convolution of the conv route;
  * fft: large templates over large search areas (not bit-exact, ~1e-7
    relative);
  * conv: one f64 F.conv2d everywhere else, rounded to f32 once. It is
    exact on integer inputs of any template size on every device; an f32
    convolution is not once a partial sum passes 2^24 (90x100 templates on
    full-range input move a score by 6e-5).

A stack of templates of one size (ncc_score_stack, a glyph group's sweep)
takes the same route: one correlation for the whole stack on the exact
routes (conv, shiftmm), template by template on the others.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .cuda import corr_kernel, descent_score_kernel
from .rounding import f32, fma

FLT_EPSILON = np.float32(1.1920929e-07)

# Above this many outputs the JAX package routes an eligible template to its
# tiled-band kernel (fastest_image_pattern_matching_tpu/ops/ncc.py:262).
_TILED_MIN_OUT = 65536


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
    """Raw centred cross-correlation [B, H, W] x [h, w] -> [B, Ho, Wo] as
    one f64 convolution, rounded to f32 once; a stack of templates
    [G, h, w] -> [B, G, Ho, Wo], one output channel a template. Exact on
    integer inputs (every sum below 2^53) whatever the summation order,
    so the same on the card and on the CPU."""
    c = canvases_c.to(torch.float64)[:, None]
    t = templ_c.to(torch.float64)
    if templ_c.ndim == 2:
        return F.conv2d(c, t[None, None])[:, 0].to(torch.float32)
    return F.conv2d(c, t[:, None]).to(torch.float32)


def ccorr_shiftmm(canvases_c: torch.Tensor, templ_c: torch.Tensor
                  ) -> torch.Tensor:
    """Centred cross-correlation for small output grids as one matmul:
    score[b, s] = <roi[b], template shifted by s>, over all Ho*Wo shifts.
    templ_c [h, w] -> [B, Ho, Wo]; a stack of templates [G, h, w] ->
    [B, G, Ho, Wo], the shifts of every template in the one matmul.

    The matmul runs in f64 and is rounded to f32 once: exact on integer
    inputs (every sum below 2^53), so a candidate's score does not depend
    on how many ROIs or templates share the matmul, whose f32 summation
    order on the card follows its shape (the batch of frames and the alive
    chunks change that)."""
    B, H, W = canvases_c.shape
    h, w = templ_c.shape[-2:]
    lead = tuple(templ_c.shape[:-2])
    Ho, Wo = H - h + 1, W - w + 1
    tsh = canvases_c.new_zeros(lead + (Ho * Wo, H, W), dtype=torch.float64)
    for dy in range(Ho):
        for dx in range(Wo):
            tsh[..., dy * Wo + dx, dy:dy + h, dx:dx + w] = templ_c
    out = torch.matmul(canvases_c.reshape(B, H * W).to(torch.float64),
                       tsh.reshape(-1, H * W).T)
    return out.reshape((B,) + lead + (Ho, Wo)).to(torch.float32)


# The plain version of the correlation kernel is the exact conv route.
ccorr_tiled_ref = ccorr_conv


def ccorr_tiled(canvases_c: torch.Tensor, templ_c: torch.Tensor
                ) -> torch.Tensor:
    """The correlation of the large-map regime: the hand-written CUDA
    kernel for tensors on the card, its plain version for tensors on the
    CPU. Both raise for a template the kernel does not take. A stack of
    templates [G, h, w] runs template by template."""
    if templ_c.ndim == 3:
        return torch.stack([ccorr_tiled(canvases_c, t) for t in templ_c], 1)
    if canvases_c.is_cuda or templ_c.is_cuda:
        return corr_kernel.ccorr_valid_cuda(canvases_c, templ_c)
    corr_kernel.check_eligible(*templ_c.shape)
    return ccorr_tiled_ref(canvases_c, templ_c)


def ccorr_fft(canvases_c: torch.Tensor, templ_c: torch.Tensor
              ) -> torch.Tensor:
    """Raw centred cross-correlation via FFT -> [B, Ho, Wo] f32.

    A circular FFT of the canvas size gives the valid-mode correlation:
    the wraparound only touches outputs beyond (H-h+1, W-w+1), which are
    cut away. Not bit-exact (~1e-7 relative). A stack of templates
    [G, h, w] runs template by template."""
    if templ_c.ndim == 3:
        return torch.stack([ccorr_fft(canvases_c, t) for t in templ_c], 1)
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    fs = torch.fft.rfft2(canvases_c, s=(H, W))
    ft = torch.fft.rfft2(templ_c, s=(H, W))
    corr = torch.fft.irfft2(fs * torch.conj(ft)[None], s=(H, W))
    return corr[:, :H - h + 1, :W - w + 1].to(torch.float32)


def auto_method(H: int, W: int, h: int, w: int) -> str:
    """The correlation route of method="auto", the JAX package's rule
    (fastest_image_pattern_matching_tpu/ops/ncc.py:246-288): "shiftmm" for
    small outputs; "tiledband" for large maps with an eligible template;
    otherwise "fft" or "conv" by its operation-count estimate (its FFT
    weight was set for the TPU). Where JAX takes its banded form, a TPU
    workaround the port does not have, its banded cost is at least the conv
    cost (W >= w), so the estimate below already gives "conv"."""
    Ho, Wo = H - h + 1, W - w + 1
    if Ho * Wo <= 512:
        return "shiftmm"
    if Ho * Wo > _TILED_MIN_OUT and corr_kernel.eligible(h, w):
        return "tiledband"
    conv_cost = Ho * Wo * h * w
    fft_cost = 4000.0 * H * W * math.log2(max(H * W, 2))
    return "fft" if conv_cost > fft_cost else "conv"


# The correlation of each method by name (ncc_score_map's `method`).
_CORRELATIONS = {"shiftmm": ccorr_shiftmm, "tiledband": ccorr_tiled,
                 "fft": ccorr_fft, "conv": ccorr_conv}


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

    method: "conv", "shiftmm", "tiledband" (the correlation kernel on the
    card, its plain version on the CPU), "fft", "banded" (served like
    "tiledband", or "conv" for a template the kernel does not take) or
    "auto" (auto_method).
    """
    h, w = templ.shape
    with span("fipm.ncc"):
        return _score_map(canvases, templ, score_constants(
            templ_mean, templ_norm, inv_area, float(h * w)), result_equal1,
            method)


def _method(method: str, H: int, W: int, h: int, w: int) -> str:
    """ncc_score_map's `method` as the name of a correlation route."""
    if method == "auto":
        method = auto_method(H, W, h, w)
    elif method == "banded":
        method = "tiledband" if corr_kernel.eligible(h, w) else "conv"
    if method not in _CORRELATIONS:
        raise ValueError(f"unknown correlation method {method!r} (expected "
                         "auto|conv|shiftmm|tiledband|banded|fft)")
    return method


def _score_map(canvases, templ, consts, result_equal1, method):
    """ncc_score_map with the epilogue's constants (score_constants). A
    stack of templates templ [G, h, w] takes consts as a [G, 6] f32 tensor
    on the canvases' device (row g template g's) and gives every canvas's
    G maps [B, G, Ho, Wo]: the window sums depend on the template's size
    alone and run once, the correlation takes the stack as it takes one
    template, and the epilogue reads each template's constants as f32
    tensors, the same values. Map g equals the map of template g alone
    bit for bit on integer inputs."""
    h, w = templ.shape[-2:]
    lead = tuple(templ.shape[:-2])
    B, H, W = canvases.shape
    Ho, Wo = H - h + 1, W - w + 1
    if result_equal1:
        return canvases.new_ones((B,) + lead + (Ho, Wo))

    sc = canvases - 128.0
    tc = templ - 128.0
    correlate = _CORRELATIONS[_method(method, H, W, h, w)]
    with span("fipm.ncc.corr"):
        ccorr_c = correlate(sc, tc)
    with span("fipm.ncc.sums"):
        s1c = window_sums(sc, (h, w))
        s2c = window_sums(sc * sc, (h, w))
    if lead:
        s1c, s2c = s1c[:, None], s2c[:, None]
        consts = consts.T.reshape(6, lead[0], 1, 1).unbind(0)
    with span("fipm.ncc.score"):
        return _scores(ccorr_c, s1c, s2c, consts)


def ncc_score_stack(canvases: torch.Tensor, templs: torch.Tensor,
                    consts: torch.Tensor, result_equal1: bool,
                    method: str = "auto") -> torch.Tensor:
    """ncc_score_map of each of G templates of one size, templs [G, h, w],
    against the same canvases [B, H, W] -> [B, G, Ho, Wo] f32; consts
    [G, 6] f32 on the canvases' device, row g template g's
    score_constants (_score_map)."""
    with span("fipm.ncc"):
        return _score_map(canvases, templs, consts, result_equal1, method)


def score_constants(templ_mean: float, templ_norm: float, inv_area: float,
                    area: float) -> Tuple[float, ...]:
    """The scalars of the NCC epilogue, each rounded to f32 once on the
    host: 128 - mean, 16384 * area, inv_area, the template norm, the
    cutoff's 10 * FLT_EPSILON and the divisor's floor 1e-30. _scores and
    the descent-score kernel take these six."""
    return (f32(128.0 - f32(templ_mean)), f32(16384.0 * area),
            f32(inv_area), f32(templ_norm), f32(10.0 * FLT_EPSILON),
            f32(1e-30))


def _scores(ccorr_c, s1c, s2c, consts):
    """The NCC epilogue: the centred correlation and the window sums to
    scores, with the reference's epsilon and 1.125 guards; consts from
    score_constants."""
    mean_c, area_c, inv_area_c, norm_c, eps10, tiny = consts

    # Both sums are single-rounding multiply-adds: the cancellation in
    # diff2 = s2c - s1c^2/area is the epilogue's most fragile step, and
    # this is also the form the JAX package compiles to on the CPU.
    num = fma(s1c, mean_c, ccorr_c)
    wnd_sum2 = s2c + 256.0 * s1c + area_c
    diff2 = torch.clamp_min(fma(-(s1c * s1c), inv_area_c, s2c), 0.0)

    cutoff = torch.clamp_max(eps10 * wnd_sum2, 0.5)
    t = torch.where(diff2 <= cutoff, 0.0, torch.sqrt(diff2) * norm_c)

    num_abs = torch.abs(num)
    safe_t = torch.clamp_min(t, tiny)
    return torch.where(
        num_abs < t, num / safe_t,
        torch.where(num_abs < t * 1.125, torch.sign(num), 0.0))


def roi_best(smap: torch.Tensor, cc: int, k_ang: int):
    """The best of each descent ROI's 7x7 score map [cc * k_ang, 7, 7]
    (first max in row-major order): its value, (x, y), whether it lies
    on the border, and the 3x3 patch around it, clamped inside, for the
    subpixel fit; each reshaped to [cc, k_ang, ...]."""
    dev = smap.device
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


def descent_best_ref(rois, templ, templ_mean, templ_norm, inv_area,
                     result_equal1, cc: int, k_ang: int):
    """The best of each descent ROI rois [cc * k_ang, h + 6, w + 6]
    against templ [h, w]: its 7x7 score map by the shiftmm route, then
    roi_best. The plain version of the descent-score kernel, and the
    descent's route wherever the kernel does not serve."""
    smap = ncc_score_map(rois, templ, templ_mean, templ_norm, inv_area,
                         result_equal1, method="shiftmm")
    with span("fipm.descent.best"):
        return roi_best(smap, cc, k_ang)


def descent_best_stack_ref(rois, templs, templ_index, consts,
                           result_equal1, cc: int, k_ang: int):
    """descent_best_ref for ROIs of a stack of templates of one size:
    ROI b against templs[templ_index[b]] [G, h, w] with that template's
    row of consts [G, 6] (score_constants; the k_ang ROIs of a candidate
    share its template). Each template's ROIs are scored as
    descent_best_ref scores them and scattered back, so the outputs equal
    descent_best_ref's of each ROI with its own template bit for bit.
    Reads the index and the table back (host syncs): the plain version,
    and the route of the CPU."""
    H, W = rois.shape[-2:]
    per_cand = templ_index.reshape(cc, k_ang)[:, 0]
    table = consts.tolist()
    out = None
    for g in torch.unique(per_cand).tolist():
        sel = torch.nonzero(per_cand == g)[:, 0]
        part = rois.reshape(cc, k_ang, H, W)[sel].reshape(-1, H, W)
        with span("fipm.ncc"):
            smap = _score_map(part, templs[g], tuple(table[g]),
                              result_equal1, "shiftmm")
        with span("fipm.descent.best"):
            got = roi_best(smap, sel.shape[0], k_ang)
        if out is None:
            out = tuple(x.new_zeros((cc,) + x.shape[1:]) for x in got)
        for o, x in zip(out, got):
            o[sel] = x
    return out


def descent_best_stack(rois, templs, templ_index, consts, result_equal1,
                       cc: int, k_ang: int, integer: bool):
    """descent_best for a stack of templates (descent_best_stack_ref's
    arguments): on the card, where the caller vouches for integers in
    [0, 255] and the templates are not flat, one launch of the
    descent-score kernel with the template index; everywhere else the
    plain version."""
    if integer and not result_equal1 and rois.is_cuda:
        with span("fipm.descent.score"):
            return descent_score_kernel.descent_score_cuda(
                rois, templs, consts, cc, k_ang, templ_index)
    return descent_best_stack_ref(rois, templs, templ_index, consts,
                                  result_equal1, cc, k_ang)


def descent_best(rois, templ, templ_mean, templ_norm, inv_area,
                 result_equal1, cc: int, k_ang: int, integer: bool):
    """descent_best_ref's outputs. On the card, where the caller vouches
    that the ROIs and the template hold integers in [0, 255] (`integer`)
    and the template is not flat, from one launch of the descent-score
    kernel (ops/cuda/descent_score_kernel.py), whose integer sums make it
    bit-equal to the plain version; everywhere else from the plain
    version."""
    if integer and not result_equal1 and rois.is_cuda:
        with span("fipm.descent.score"):
            h, w = templ.shape
            return descent_score_kernel.descent_score_cuda(
                rois, templ, score_constants(templ_mean, templ_norm,
                                             inv_area, float(h * w)),
                cc, k_ang)
    return descent_best_ref(rois, templ, templ_mean, templ_norm, inv_area,
                            result_equal1, cc, k_ang)
