"""Wrapper of the hand-written CUDA peak kernel (csrc/peaks.cu).

Replaces no TPU kernel: the JAX package's greedy peak rounds
(fastest_image_pattern_matching_tpu/ops/peaks.py::extract_peaks) are XLA
operations in a fori_loop, one compiled program. The port's plain version,
ops/peaks.py::extract_peaks_ref, launches about 27 PyTorch operators a
round from Python, so a many-target match spent its time on the host's
launch path. Here all k rounds of a call run on the card, in one launch
for small maps (each map in one block's shared memory) or two for large
ones (a tile-max cache, then every round in one block per map). Both give
the plain loop's results bit for bit; the kernel is set by its chain of
dependent rounds, not by bytes (see the source). ops/peaks.py::
extract_peaks sends CPU tensors to the plain version and CUDA tensors here.

The library is built with nvcc at the first launch, never on import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.profiling import count
from . import build, launch

SOURCE = "peaks.cu"

# Maps of up to SMALL_MAX values take the small form: one block of 256
# threads holds the map in shared memory (64 KB at most, of the 227 KB a
# block may have on the H100) and scans all of it every round. Larger maps
# take the tile-max cache, whose round scans the cache and at most four
# tiles. The two forms on the same maps, device ms for K 30 and a 27x27
# rectangle, small / tile, on one H100 at 700 W (chip_smoke.py phase 23):
# 0.049 / 0.143 at 64x64, 0.106 / 0.139 at 128x128, 0.149 / 0.139 at
# 160x160, 0.216 / 0.142 at 200x200, for 1 map and for 41 alike. The
# small form grows with the map and the tile form does not: they cross
# between 128x128 and 160x160.
SMALL_MAX = 16384
# Tiles are TILE x TILE values (a row of a tile is one 128-byte line) or
# the rectangle's size if larger, so that a rectangle touches at most 2 x 2
# tiles; doubled while a map has more than MAX_TILES, so that the cache
# (8 bytes a tile) stays within 32 KB of shared memory.
TILE = 32
MAX_TILES = 4096

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.fipm_peaks.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.fipm_peaks.restype = ctypes.c_int
        lib.fipm_peaks_error_string.argtypes = [ctypes.c_int]
        lib.fipm_peaks_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def plan(Hs: int, Ws: int, sw: int, sh: int) -> Optional[Tuple[int, int]]:
    """The tile shape (TH, TW) of the tile-cache form for an Hs x Ws map
    with an sw x sh rectangle, or None where the map takes the small
    form."""
    if Hs * Ws <= SMALL_MAX:
        return None
    th = max(TILE, sh)
    tw = max(TILE, -(-sw // TILE) * TILE)
    while -(-Hs // th) * -(-Ws // tw) > MAX_TILES:
        th, tw = 2 * th, 2 * tw
    return th, tw


def extract_peaks_cuda(scores: torch.Tensor, k: int, sw: int, sh: int,
                       off_x: float, off_y: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k greedy rounds over each map of scores [A, Hs, Ws] f32 on the
    current stream -> (vals [A, k] f32, locs [A, k, 2] int32 as (x, y)),
    exactly as ops/peaks.py::extract_peaks_ref; raises on anything the
    kernel does not take. Reads nothing back from the card. Each launch
    counts as "peaks.launches", and each call that takes the tile-cache
    form once as "peaks.tiled" (utils/profiling.py::counter)."""
    if scores.ndim != 3:
        raise ValueError(f"scores must be [A, Hs, Ws], got "
                         f"{tuple(scores.shape)}")
    if scores.dtype != torch.float32:
        raise TypeError(f"extract_peaks_cuda takes float32, got "
                        f"{scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("extract_peaks_cuda takes a contiguous tensor")
    if not scores.is_cuda:
        raise ValueError(f"extract_peaks_cuda needs a CUDA tensor, got "
                         f"{scores.device}")
    A, Hs, Ws = scores.shape
    if k < 1 or Hs * Ws == 0:
        raise ValueError(f"need k >= 1 and non-empty maps, got k={k} and "
                         f"{Hs}x{Ws} maps")
    if Hs * Ws >= 2**31:
        raise ValueError(f"{Hs}x{Ws} maps exceed the kernel's index range")
    dev = scores.device
    vals = torch.empty((A, k), dtype=torch.float32, device=dev)
    locs = torch.empty((A, k, 2), dtype=torch.int32, device=dev)
    if A == 0:
        return vals, locs
    tiles = plan(Hs, Ws, sw, sh)
    lib = _LIB or _lib()
    if tiles is None:
        th = tw = 0
        work = tile_max = tile_idx = 0
    else:
        if A > 65535:
            raise ValueError(f"{A} maps exceed the tile form's grid")
        th, tw = tiles
        n_tiles = -(-Hs // th) * -(-Ws // tw)
        work_t = torch.empty_like(scores)
        max_t = torch.empty((A, n_tiles), dtype=torch.float32, device=dev)
        idx_t = torch.empty((A, n_tiles), dtype=torch.int32, device=dev)
        work, tile_max, tile_idx = (work_t.data_ptr(), max_t.data_ptr(),
                                    idx_t.data_ptr())
    err = launch.launch(lib.fipm_peaks, dev, scores.data_ptr(), A, Hs, Ws,
                        k, sw, sh, off_x, off_y, th, tw, work, tile_max,
                        tile_idx, vals.data_ptr(), locs.data_ptr())
    if err != 0:
        raise RuntimeError("peaks kernel launch failed: "
                           + lib.fipm_peaks_error_string(err).decode())
    if tiles is None:
        count("peaks.launches")
    else:
        count("peaks.launches", 2)
        count("peaks.tiled")
    return vals, locs
