"""The byte-serial loops of PNG and TIFF decode through the native library:
PNG unfiltering, TIFF LZW, PackBits and the horizontal predictor.
utils/codecs/png.py and tiff.py hold their numpy / pure-Python twins,
which their callers use exactly when available() is False, and which the
tests hold these bit-equal to."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import can_build, get_lib

# Answers of available() that were False: each one sent a decode loop to
# its Python twin because g++ is missing.
FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()


def available() -> bool:
    """True when the native loops can be used (built, or g++ present; a
    build that fails raises). Each False is counted in FALLBACKS."""
    global FALLBACKS
    if can_build():
        get_lib()
        return True
    with _FALLBACK_LOCK:
        FALLBACKS += 1
    return False


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def png_unfilter(data: np.ndarray, rows: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """`rows` filtered rows (a filter-type byte and `row_bytes` bytes each)
    of a u8 array, unfiltered into a (rows, row_bytes) u8 array; `bpp`
    bytes per complete pixel. Raises ValueError on an unknown filter."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size < rows * (row_bytes + 1):
        raise ValueError("PNG: not enough image data")
    out = np.empty((rows, row_bytes), np.uint8)
    bad = get_lib().fipm_png_unfilter(_u8p(data), rows, row_bytes, bpp,
                                      _u8p(out))
    if bad:
        raise ValueError(f"PNG: unknown filter type in row {bad - 1}")
    return out


def _stream(fn, data: bytes, size: int) -> np.ndarray:
    src = np.frombuffer(data, np.uint8)
    out = np.empty(size, np.uint8)
    n = fn(_u8p(src), src.size, _u8p(out), size)
    if n < 0:
        raise ValueError("TIFF: corrupt LZW code")
    return out[:n]


def lzw_decode(data: bytes, size: int) -> np.ndarray:
    """TIFF LZW of `data`, at most `size` bytes (fewer when the stream
    ends early). Raises ValueError on a code outside the table."""
    return _stream(get_lib().fipm_tiff_lzw_decode, data, size)


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    """TIFF PackBits of `data`, at most `size` bytes."""
    return _stream(get_lib().fipm_tiff_packbits_decode, data, size)


def unpredict(a: np.ndarray) -> None:
    """Undoes the horizontal predictor in place on a C-contiguous
    (rows, cols, spp) u8 or native-order u16 array."""
    if not a.flags.c_contiguous or a.ndim != 3:
        raise ValueError("unpredict takes a C-contiguous (rows, cols, spp) "
                         "array")
    lib = get_lib()
    if a.dtype == np.uint8:
        lib.fipm_tiff_unpredict_u8(_u8p(a), *a.shape)
    elif a.dtype == np.uint16:
        lib.fipm_tiff_unpredict_u16(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), *a.shape)
    else:
        raise ValueError(f"unpredict takes u8 or u16, got {a.dtype}")
