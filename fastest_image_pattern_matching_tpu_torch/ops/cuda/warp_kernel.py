"""Wrapper of the hand-written CUDA warp kernel (csrc/warp_affine.cu).

Replaces fastest_image_pattern_matching_tpu/ops/pallas/warp_kernel.py::
warp_affine_pallas, and takes a stack of sources as well: the frames of a
batch share one launch, map b reading source src_index[b]. A block stages
the source footprint of its 32x32 output tile in shared memory and
gathers its taps there; each thread writes 4 consecutive outputs as one
float4 in each of 2 rows. It is bound by memory (the outputs written once
and the source pixels the maps touch). Its plain PyTorch version is
ops/warp.py::warp_affine_batch; ops/warp.py::warp_affine_dispatch sends CPU
tensors there and CUDA tensors here.

The library is built with nvcc at the first launch, never on import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.profiling import count
from . import build, launch

SOURCE = "warp_affine.cu"

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.fipm_warp_affine.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.fipm_warp_affine.restype = ctypes.c_int
        lib.fipm_error_string.argtypes = [ctypes.c_int]
        lib.fipm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def warp_affine_cuda(src: torch.Tensor, inv_mats: torch.Tensor,
                     out_hw: Tuple[int, int], border_value: float,
                     quantize: bool = True,
                     src_index: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on anything the
    kernel does not take.

    src is one source [H, W], or a stack [N, H, W] with src_index [B]
    int32 on the same card: map b samples source src_index[b]. The index
    is checked to lie in [0, N) (one host read of its range). Each launch
    counts as "warp.launches" (utils/profiling.py::counter); the plain
    path on the CPU does not count."""
    if not (src.is_cuda and inv_mats.is_cuda and src.device == inv_mats.device):
        raise ValueError(f"warp_affine_cuda needs both tensors on one CUDA "
                         f"device, got {src.device} and {inv_mats.device}")
    if src.dtype != torch.float32 or inv_mats.dtype != torch.float32:
        raise TypeError(f"warp_affine_cuda takes float32, got {src.dtype} "
                        f"and {inv_mats.dtype}")
    if src.ndim != (2 if src_index is None else 3) or inv_mats.ndim != 3 \
            or inv_mats.shape[1:] != (2, 3):
        raise ValueError(f"bad shapes src {tuple(src.shape)}, inv_mats "
                         f"{tuple(inv_mats.shape)} (a stack [N, H, W] takes "
                         "a src_index, one source [H, W] none)")
    if not (src.is_contiguous() and inv_mats.is_contiguous()):
        raise ValueError("warp_affine_cuda takes contiguous tensors")
    H, W = src.shape[-2:]
    Ho, Wo = (int(v) for v in out_hw)
    B = inv_mats.shape[0]
    if not (B <= 65535 and (Ho + 31) // 32 <= 65535
            and max(H * W, B * Ho * Wo) < 2**31):
        raise ValueError(f"warp of {B}x{Ho}x{Wo} from {H}x{W} exceeds the "
                         "kernel's grid or index range")
    idx_ptr = None
    if src_index is not None:
        if src_index.device != src.device or src_index.dtype != torch.int32 \
                or src_index.shape != (B,) or not src_index.is_contiguous():
            raise ValueError(f"src_index must be a contiguous int32 [{B}] "
                             f"tensor on {src.device}, got "
                             f"{src_index.dtype} {tuple(src_index.shape)} "
                             f"on {src_index.device}")
        if B:
            lo, hi = torch.aminmax(src_index)
            lo, hi = torch.stack([lo, hi]).tolist()
            if lo < 0 or hi >= src.shape[0]:
                raise ValueError(f"src_index spans [{lo}, {hi}], outside "
                                 f"the {src.shape[0]} sources")
        idx_ptr = src_index.data_ptr()
    out = torch.empty((B, Ho, Wo), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    lib = _LIB or _lib()
    err = launch.launch(
        lib.fipm_warp_affine, src.device, src.data_ptr(), H, W, idx_ptr,
        inv_mats.data_ptr(), B, out.data_ptr(), Ho, Wo, float(border_value),
        int(bool(quantize)),
        launch.counters("warp_global_blocks", src.device, 1).data_ptr())
    if err != 0:
        raise RuntimeError("warp_affine kernel launch failed: "
                           + lib.fipm_error_string(err).decode())
    count("warp.launches")
    return out


def global_tap_blocks(reset: bool = False) -> int:
    """Blocks launched so far whose tap box exceeded the staging buffer and
    which read their taps from global memory (one host sync)."""
    return launch.read_counters("warp_global_blocks", 1, reset)[0]
