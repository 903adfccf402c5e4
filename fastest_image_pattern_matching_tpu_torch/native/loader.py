"""Threaded batch image loader: native decode threads and an ordered take.

The analogue of the reference's camera grabber thread (QImageAcquisition,
src/CameraPreviewDialog.cpp:42-131): BMPs decode on CPU threads while the
device matches the previous batch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from . import get_lib


class BatchLoader:
    """Decodes a list of BMPs concurrently; take(i) blocks until item i is
    decoded and returns it, or None when it could not be decoded."""

    def __init__(self, paths: List[str], n_threads: int = 4):
        self._lib = get_lib()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(paths)
        self._handle = self._lib.fipm_loader_create(arr, self._n, n_threads)

    def take(self, index: int) -> Optional[np.ndarray]:
        if not 0 <= index < self._n:
            raise IndexError(index)
        if not self._handle:
            raise ValueError("BatchLoader is closed")
        w = ctypes.c_int()
        h = ctypes.c_int()
        if not self._lib.fipm_loader_shape(self._handle, index,
                                           ctypes.byref(w), ctypes.byref(h)):
            return None
        out = np.empty((h.value, w.value), np.uint8)
        if not self._lib.fipm_loader_take(
                self._handle, index,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
            return None
        return out

    def close(self) -> None:
        """Waits for the decode threads and frees the loader."""
        if self._handle:
            self._lib.fipm_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
