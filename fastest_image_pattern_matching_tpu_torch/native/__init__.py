"""The port's native host library (ctypes bindings to src/fipm_native.cc):
the BMP codec, the threaded BatchLoader, the host peak / NMS oracles and
the byte-serial loops of PNG and TIFF decode (decode.py).

g++ builds the library at first use, never on import, into `_build/`
beside the package (listed in .gitignore). The file name carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. A failed build raises with g++'s report. A
library built elsewhere (a deployment pack, aot.py) is put in place with
`install` when its `library_identity` is this package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "src", "fipm_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

# g++ processes started in this process.
GXX_RUNS = 0

_LOCK = threading.Lock()
_LIB = None


def _digest() -> str:
    with open(SOURCE, "rb") as f:
        return hashlib.sha256(f.read() + repr(CXX_FLAGS).encode()).hexdigest()


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libfipm_native_{_digest()[:16]}.so")


def library_identity() -> dict:
    """What the library built by this package is: the hash of the source
    and the flags (its file name carries the first 16 hex digits) and the
    host's machine type."""
    return {"file": os.path.basename(library_path()), "sha256": _digest(),
            "machine": platform.machine()}


def install(data: bytes, identity: dict) -> str:
    """Put a prebuilt library in place under library_path(), atomically
    (written beside it, then os.replace); an existing file is left as it
    is. Raises ValueError when `identity` is not library_identity().
    Returns the path."""
    if identity != library_identity():
        raise ValueError(f"native library built as {identity}, this "
                         f"package builds {library_identity()}")
    out = library_path()
    with _LOCK:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, out)
    return out


def can_build() -> bool:
    """True when the library is built already or g++ is on the PATH."""
    return os.path.exists(library_path()) or shutil.which(CXX) is not None


def build():
    """Compile the library unless it is built already. Returns (path,
    seconds spent compiling in this call); raises RuntimeError with g++'s
    report when the build fails."""
    global GXX_RUNS
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    compiler = shutil.which(CXX)
    if compiler is None:
        raise RuntimeError(f"{CXX} not found; the native library is built "
                           f"from {SOURCE} at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    GXX_RUNS += 1
    proc = subprocess.run([compiler, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) for "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, _ = build()
        lib = ctypes.CDLL(path)
        lib.fipm_bmp_load_gray.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.fipm_bmp_load_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.fipm_bmp_save_gray.restype = ctypes.c_int
        lib.fipm_bmp_save_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        lib.fipm_free.restype = None
        lib.fipm_free.argtypes = [ctypes.c_void_p]
        lib.fipm_extract_peaks.restype = ctypes.c_int
        lib.fipm_extract_peaks.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float)]
        lib.fipm_filter_overlaps.restype = None
        lib.fipm_filter_overlaps.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_double, ctypes.c_double]
        lib.fipm_loader_create.restype = ctypes.c_void_p
        lib.fipm_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
        lib.fipm_loader_shape.restype = ctypes.c_int
        lib.fipm_loader_shape.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.fipm_loader_take.restype = ctypes.c_int
        lib.fipm_loader_take.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.fipm_loader_destroy.restype = None
        lib.fipm_loader_destroy.argtypes = [ctypes.c_void_p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.fipm_png_unfilter.restype = i64
        lib.fipm_png_unfilter.argtypes = [u8p, i64, i64, ctypes.c_int, u8p]
        for name in ("fipm_tiff_lzw_decode", "fipm_tiff_packbits_decode"):
            getattr(lib, name).restype = i64
            getattr(lib, name).argtypes = [u8p, i64, u8p, i64]
        lib.fipm_tiff_unpredict_u8.restype = None
        lib.fipm_tiff_unpredict_u8.argtypes = [u8p, i64, i64, ctypes.c_int]
        lib.fipm_tiff_unpredict_u16.restype = None
        lib.fipm_tiff_unpredict_u16.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), i64, i64, ctypes.c_int]
        _LIB = lib
        return _LIB
