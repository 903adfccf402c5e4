"""Wrapper of the hand-written CUDA descent-score kernel
(csrc/descent_score.cu).

Replaces no TPU kernel: the JAX package computes a descent chunk's 7x7
score maps and their best with XLA operations
(fastest_image_pattern_matching_tpu/models/template_matcher.py:374-378).
The port's plain version, ops/ncc.py::descent_best_ref (ncc_score_map's
shiftmm route, then roi_best), launches about 115 kernels a chunk from
Python. Here one launch turns a chunk's ROIs into each ROI's best, with
exact integer sums, bit-equal to the plain version. ops/ncc.py::
descent_best sends CUDA tensors here when the ROIs and the template hold
integers in [0, 255], and everything else to the plain version;
ops/ncc.py::descent_best_stack sends a chunk whose ROIs belong to a stack
of templates (a glyph group, models/batch.py::_match_group) here in one
launch as well, with each ROI's template index and the stack's table of
constants.

The library is built with nvcc at the first launch, never on import.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...utils.profiling import count
from . import build, launch

SOURCE = "descent_score.cu"

# Template rows a block takes at most (the source's kMaxRows): 33 bands of
# the flagship's 521-row level 0, 792 blocks for its 24 ROIs.
MAX_ROWS = 16
# Dynamic shared memory a block may ask for: the H100's 227 KB less room
# for the kernel's static arrays (under 3 KB).
SMEM_MAX = 224 * 1024
# Words of 64 bits of scratch a ROI: 147 sums and a ticket.
SCRATCH_WORDS = 148

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.fipm_descent_score.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 +
            [ctypes.c_int] * 3 + [ctypes.c_void_p] +
            [ctypes.c_float] * 6 + [ctypes.c_void_p] * 6)
        lib.fipm_descent_score.restype = ctypes.c_int
        lib.fipm_descent_score_error_string.argtypes = [ctypes.c_int]
        lib.fipm_descent_score_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def smem_bytes(rows: int, w: int) -> int:
    """Dynamic shared memory of a block of `rows` template rows: those rows
    and the rows + 6 ROI rows they touch, as words of four int8 values (a
    ROI row two words longer)."""
    nq = -(-w // 4)
    return 4 * ((rows + 6) * (nq + 2) + rows * nq)


def plan(h: int, w: int) -> int:
    """Template rows a block of an h x w template takes: MAX_ROWS, or
    fewer where a wide template's rows would not fit SMEM_MAX. Raises for
    a template too wide for one row a block."""
    rows = min(MAX_ROWS, h)
    while rows > 1 and smem_bytes(rows, w) > SMEM_MAX:
        rows -= 1
    if smem_bytes(rows, w) > SMEM_MAX:
        raise ValueError(f"a {h}x{w} template is too wide for the "
                         "descent-score kernel's shared memory")
    return rows


def descent_score_cuda(rois: torch.Tensor, templ: torch.Tensor, consts,
                       cc: int, k_ang: int,
                       templ_index: Optional[torch.Tensor] = None):
    """Each ROI's best on the current stream: rois [cc * k_ang, h + 6,
    w + 6] and templ [h, w], f32 holding integers in [0, 255], and the
    epilogue's six f32 constants of the template's stats
    (ops/ncc.py::score_constants) -> (value [cc, k_ang] f32, (x, y)
    [cc, k_ang, 2] int32, border [cc, k_ang] bool, patch [cc, k_ang, 3, 3]
    f32), exactly as ops/ncc.py::descent_best_ref; raises on anything the
    kernel does not take. Reads nothing back from the card. Each launch
    counts as "descent_score.launches" (utils/profiling.py::counter).

    templ_index: for a stack of G templates templ [G, h, w], ROI b's
    template, a contiguous int32 [cc * k_ang] on the ROIs' card; consts is
    then the [G, 6] f32 table on that card whose row g holds template g's
    six constants. The index is the caller's (each entry in [0, G)): it is
    not read back to be checked."""
    stacked = templ_index is not None
    if rois.ndim != 3 or templ.ndim != (3 if stacked else 2):
        raise ValueError(f"rois must be [B, h + 6, w + 6] and templ "
                         f"{'[G, h, w]' if stacked else '[h, w]'}, got "
                         f"{tuple(rois.shape)} and {tuple(templ.shape)}")
    h, w = templ.shape[-2:]
    B = rois.shape[0]
    if tuple(rois.shape[1:]) != (h + 6, w + 6) or B != cc * k_ang:
        raise ValueError(f"rois {tuple(rois.shape)} are not {cc} x {k_ang} "
                         f"ROIs of the {h}x{w} template grown by 6")
    if rois.dtype != torch.float32 or templ.dtype != torch.float32:
        raise TypeError(f"descent_score_cuda takes float32, got "
                        f"{rois.dtype} and {templ.dtype}")
    if not (rois.is_contiguous() and templ.is_contiguous()):
        raise ValueError("descent_score_cuda takes contiguous tensors")
    if stacked:
        _check_stack(templ_index, consts, B, templ.shape[0], rois.device)
    if not (rois.is_cuda and templ.device == rois.device):
        raise ValueError(f"descent_score_cuda needs both tensors on one CUDA "
                         f"device, got {rois.device} and {templ.device}")
    if B > 65535:
        raise ValueError(f"{B} ROIs exceed the kernel's grid")
    rows = plan(h, w)
    dev = rois.device
    v = torch.empty((cc, k_ang), dtype=torch.float32, device=dev)
    xy = torch.empty((cc, k_ang, 2), dtype=torch.int32, device=dev)
    border = torch.empty((cc, k_ang), dtype=torch.bool, device=dev)
    patch = torch.empty((cc, k_ang, 3, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return v, xy, border, patch
    scratch = torch.zeros(B * SCRATCH_WORDS, dtype=torch.int64, device=dev)
    lib = _LIB or _lib()
    if stacked:
        index, table, scalars = templ_index.data_ptr(), consts.data_ptr(), \
            (0.0,) * 6
    else:
        index, table, scalars = None, None, consts
    err = launch.launch(
        lib.fipm_descent_score, dev, rois.data_ptr(), B, templ.data_ptr(),
        index, h, w, rows, table, *scalars,
        scratch.data_ptr(), v.data_ptr(), xy.data_ptr(), border.data_ptr(),
        patch.data_ptr())
    if err != 0:
        raise RuntimeError("descent_score kernel launch failed: "
                           + lib.fipm_descent_score_error_string(err).decode())
    count("descent_score.launches")
    return v, xy, border, patch


def _check_stack(templ_index: torch.Tensor, consts: torch.Tensor, B: int,
                 G: int, dev: torch.device) -> None:
    """A stacked launch's index and constants table: their dtype, shape,
    layout and device only (no host read)."""
    for name, x, dtype, shape in (("templ_index", templ_index, torch.int32,
                                   (B,)),
                                  ("consts", consts, torch.float32, (G, 6))):
        if not (torch.is_tensor(x) and x.dtype == dtype
                and tuple(x.shape) == shape and x.is_contiguous()
                and x.device == dev):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} on {dev}")
