"""Build the package's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

nvcc runs at first use, never on import, from the sources under `csrc/`,
into `_build/` beside them (listed in .gitignore). A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. There is no fallback: without nvcc or
a card, building raises.

A library built elsewhere (a deployment pack, aot.py) is put in place with
`install`, under the exact name a build would give it, when its
`library_identity` (source and flags, target arch, CUDA version) is this
package's; the next load then runs no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# nvcc processes started in this process.
NVCC_RUNS = 0

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


def _digest(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        return hashlib.sha256(f.read() + repr(NVCC_FLAGS).encode()).hexdigest()


def _library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(source)[:16]}.so")


def library_identity(source: str) -> dict:
    """What a library built from csrc/<source> by this package is: the
    hash of the source and the flags (its file name carries the first 16
    hex digits), the target arch and the CUDA version torch was built
    against."""
    return {"file": os.path.basename(_library_path(source)),
            "sha256": _digest(source), "arch": ARCH,
            "cuda": torch.version.cuda}


def install(source: str, data: bytes, identity: dict) -> str:
    """Put a prebuilt library for csrc/<source> in place, under the name a
    build would give it, atomically (written beside it, then os.replace).
    An existing file is left as it is. Raises ValueError when `identity`
    is not this package's library_identity(source). Returns the path."""
    if identity != library_identity(source):
        raise ValueError(f"library for {source} built as {identity}, this "
                         f"package builds {library_identity(source)}")
    out = _library_path(source)
    with _LOCK:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, out)
    return out


def build_all(sources):
    """Compile every csrc/<source> not built yet, one nvcc process each, all
    started together. Returns [(path, seconds, compiler report)] in the
    order given; seconds is 0 and the report empty for a library that was
    already built."""
    global NVCC_RUNS
    with _LOCK:
        results, procs = {}, []
        for source in sources:
            out = _library_path(source)
            if os.path.exists(out):
                results[source] = (out, 0.0, "")
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            NVCC_RUNS += 1
            procs.append((source, out, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        for source, out, tmp, t0, proc in procs:
            report, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                                   f"{source}:\n{report}")
            os.replace(tmp, out)
            results[source] = (out, secs, report)
        return [results[s] for s in sources]


def build(source: str):
    """Compile csrc/<source> (once per content) and return
    (path, seconds spent compiling in this call, compiler report)."""
    return build_all([source])[0]


def load(source: str) -> ctypes.CDLL:
    path, _, _ = build(source)
    return ctypes.CDLL(path)
