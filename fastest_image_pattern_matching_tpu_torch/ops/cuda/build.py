"""Build the package's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

nvcc runs at first use, never on import, from the sources under `csrc/`,
into `_build/` beside them (listed in .gitignore). A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. There is no fallback: without nvcc or
a card, building raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def build(source: str):
    """Compile csrc/<source> (once per content) and return
    (path, seconds spent compiling in this call, compiler report)."""
    src_path = os.path.join(CSRC_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    with _LOCK:
        if os.path.exists(out):
            return out, 0.0, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out, secs, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    path, _, _ = build(source)
    return ctypes.CDLL(path)
