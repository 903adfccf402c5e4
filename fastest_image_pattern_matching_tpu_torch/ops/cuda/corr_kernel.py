"""Wrapper of the hand-written CUDA correlation kernel (csrc/ccorr_valid.cu).

Replaces fastest_image_pattern_matching_tpu/ops/pallas/corr_kernel.py::
ccorr_tiledband_pallas: the valid-mode raw centred correlation of B
canvases with one small template. Each block checks, while it stages its
canvas window, whether every value is an integer in [-128, 127]; if so it
runs a banded-Toeplitz int8 GEMM on the tensor cores (mma.sync, exact
int32 sums), else the f32-FMA/f64 path. Both are exact on integer inputs,
so the kernel is bit-equal to its plain version there. The function is
bound by memory (7.8 us at the many-target path's 1824x1824 x 27x27
shape); see the source for the numbers. Its plain PyTorch version is
ops/ncc.py::ccorr_tiled_ref; ops/ncc.py::ccorr_tiled sends CPU tensors
there and CUDA tensors here.

The library is built with nvcc at the first launch, never on import.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.profiling import count
from . import build, launch

SOURCE = "ccorr_valid.cu"

# Template shapes the kernel takes: the TPU kernel's eligibility
# (fastest_image_pattern_matching_tpu/ops/pallas/corr_kernel.py:78-83).
MAX_W = 129
MAX_H = 64

_LIB = None


def eligible(h: int, w: int) -> bool:
    return 2 <= w <= MAX_W and 1 <= h <= MAX_H


def check_eligible(h: int, w: int) -> None:
    if not eligible(h, w):
        raise ValueError(f"the correlation kernel takes 2 <= w <= {MAX_W} "
                         f"and 1 <= h <= {MAX_H}; got a {h}x{w} template "
                         "(use method='conv' or 'fft')")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.fipm_ccorr_valid.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fipm_ccorr_valid.restype = ctypes.c_int
        lib.fipm_ccorr_error_string.argtypes = [ctypes.c_int]
        lib.fipm_ccorr_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def ccorr_valid_cuda(canvases_c: torch.Tensor, templ_c: torch.Tensor
                     ) -> torch.Tensor:
    """[B, H, W] x [h, w] -> [B, H-h+1, W-w+1] f32 on the current stream;
    raises on anything the kernel does not take. Each launch counts as
    "corr.launches" (utils/profiling.py::counter); the plain path on the
    CPU does not count."""
    if canvases_c.ndim != 3 or templ_c.ndim != 2:
        raise ValueError(f"bad shapes canvases {tuple(canvases_c.shape)}, "
                         f"templ {tuple(templ_c.shape)}")
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    check_eligible(h, w)
    if not (canvases_c.is_cuda and templ_c.is_cuda
            and canvases_c.device == templ_c.device):
        raise ValueError(f"ccorr_valid_cuda needs both tensors on one CUDA "
                         f"device, got {canvases_c.device} and "
                         f"{templ_c.device}")
    if canvases_c.dtype != torch.float32 or templ_c.dtype != torch.float32:
        raise TypeError(f"ccorr_valid_cuda takes float32, got "
                        f"{canvases_c.dtype} and {templ_c.dtype}")
    if not (canvases_c.is_contiguous() and templ_c.is_contiguous()):
        raise ValueError("ccorr_valid_cuda takes contiguous tensors")
    if h > H or w > W:
        raise ValueError(f"template {h}x{w} larger than canvas {H}x{W}")
    if not (B <= 65535 and (H - h + 64) // 64 <= 65535
            and B * H * W < 2**31):
        raise ValueError(f"{B}x{H}x{W} canvases exceed the kernel's grid or "
                         "index range")
    out = torch.empty((B, H - h + 1, W - w + 1), dtype=torch.float32,
                      device=canvases_c.device)
    if out.numel() == 0:
        return out
    lib = _LIB or _lib()
    err = launch.launch(
        lib.fipm_ccorr_valid, canvases_c.device, canvases_c.data_ptr(), B, H,
        W, templ_c.data_ptr(), h, w, out.data_ptr(),
        launch.counters("corr_path_blocks", canvases_c.device, 2).data_ptr())
    if err != 0:
        raise RuntimeError("ccorr_valid kernel launch failed: "
                           + lib.fipm_ccorr_error_string(err).decode())
    count("corr.launches")
    return out


def path_blocks(reset: bool = False):
    """(int8 blocks, f32 blocks) launched so far: how many blocks took the
    tensor-core path and how many found a value that is not an integer in
    [-128, 127] and took the f32 path (one host sync)."""
    return tuple(launch.read_counters("corr_path_blocks", 2, reset))
