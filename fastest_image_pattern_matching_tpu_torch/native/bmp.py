"""BMP load and save through the native codec (8-bit palettised, 24- and
32-bit, both row orders, uncompressed; BT.601 luma rounded to nearest).
utils/imageio.py holds its numpy twin, which the tests hold it against."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import can_build, get_lib

# Answers of available() that were False: each one sent a .bmp read or
# write (or a FileSource) to the numpy codec because g++ is missing.
FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()


def available() -> bool:
    """True when the native codec can be used (built, or g++ present; a
    build that fails raises). Callers fall back to the numpy codec exactly
    when this returns False, and each False is counted in FALLBACKS."""
    global FALLBACKS
    if can_build():
        get_lib()
        return True
    with _FALLBACK_LOCK:
        FALLBACKS += 1
    return False


def load_gray(path: str) -> np.ndarray:
    lib = get_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.fipm_bmp_load_gray(path.encode(), ctypes.byref(w),
                                 ctypes.byref(h))
    if not buf:
        raise ValueError(f"cannot decode BMP: {path}")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value)).copy()
    finally:
        lib.fipm_free(buf)
    return arr


def save_gray(path: str, img: np.ndarray) -> None:
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"save_gray takes a 2-D image, got shape "
                         f"{img.shape}")
    rc = lib.fipm_bmp_save_gray(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[1], img.shape[0])
    if rc != 0:
        raise IOError(f"cannot write BMP: {path}")
