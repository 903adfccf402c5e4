"""The port's native library (fastest_image_pattern_matching_tpu_torch/
native/) against the JAX package's and against its own numpy twin.

The BMP codec: a round trip, 8-bit palettised, 24- and 32-bit BMPs in
both row orders decoded equal by the port's codec, the JAX package's and
the numpy twin, the bytes each writer writes, a missing file. The
BatchLoader's ordered take, FileSource through it, the counted fallback
without g++, and a failed build that raises with g++'s report. Then the
port's ops/peaks.py and ops/nms.py held against the port's own C++
oracles (fipm_extract_peaks, fipm_filter_overlaps), as tests/test_native.py
holds the JAX package's.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu.native import bmp as jbmp
from fastest_image_pattern_matching_tpu.native import get_lib as jax_get_lib

from fastest_image_pattern_matching_tpu_torch import native
from fastest_image_pattern_matching_tpu_torch.native import bmp as tbmp
from fastest_image_pattern_matching_tpu_torch.native import get_lib
from fastest_image_pattern_matching_tpu_torch.native.loader import BatchLoader
from fastest_image_pattern_matching_tpu_torch.ops.nms import (
    filter_overlaps, rotated_rect_corners)
from fastest_image_pattern_matching_tpu_torch.ops.peaks import extract_peaks
from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio
from fastest_image_pattern_matching_tpu_torch.utils import sources as tsrc

from test_torch_multi_template import _write_bmp

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def test_library_builds_into_build_dir():
    lib = get_lib()
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.exists(path) and lib is get_lib()
    assert not os.path.exists(os.path.join(os.path.dirname(native.SOURCE),
                                           "..", "fipm_native.so"))


def test_source_is_the_jax_packages_copy():
    """The port keeps its own copy of the C++ source: the JAX package's,
    unchanged, with the port's decode loops added in one marked block
    before the closing of extern "C"."""
    import fastest_image_pattern_matching_tpu.native as jnative
    jsrc = os.path.join(os.path.dirname(jnative.__file__), "src",
                        "fipm_native.cc")
    with open(jsrc, "rb") as a, open(native.SOURCE, "rb") as b:
        theirs, ours = a.read(), b.read()
    start = ours.index(b"\n// --- decode loops: the port's own")
    end = ours.index(b"// --- end of the decode loops")
    end = ours.index(b"\n", end) + 1
    assert ours[:start] + ours[end:] == theirs


def test_bmp_roundtrip_and_bytes(tmp_path):
    """A grey image written by the port's codec, the JAX package's codec
    and the numpy twin: the same bytes; read back equal by all three."""
    assert jax_get_lib() is not None
    img = np.random.default_rng(3).integers(0, 256, (37, 53), np.uint8)
    paths = {k: str(tmp_path / f"{k}.bmp") for k in ("port", "jax", "numpy")}
    tbmp.save_gray(paths["port"], img)
    jbmp.save_gray(paths["jax"], img)
    with open(paths["numpy"], "wb") as f:
        f.write(tio._bmp_gray_bytes(img))
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"] == data["numpy"]
    for p in paths.values():
        for got in (tbmp.load_gray(p), jbmp.load_gray(p), tio._bmp_gray(p)):
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("bpp,top_down", [(8, False), (8, True), (24, False),
                                          (24, True), (32, False),
                                          (32, True)])
def test_bmp_formats_vs_jax_and_numpy(tmp_path, bpp, top_down):
    rng = np.random.default_rng(bpp + top_down)
    path = str(tmp_path / "img.bmp")
    if bpp == 8:
        gray = rng.integers(0, 256, (23, 37), np.uint8)
        _write_bmp(path, gray, 8, top_down, rng.integers(0, 256, (256, 3)))
    else:
        colour = rng.integers(0, 256, (23, 37, 3), np.uint8)
        _write_bmp(path, colour, bpp, top_down)
    got = tbmp.load_gray(path)
    assert got.dtype == np.uint8 and got.shape == (23, 37)
    np.testing.assert_array_equal(got, jbmp.load_gray(path))
    np.testing.assert_array_equal(got, tio._bmp_gray(path))
    np.testing.assert_array_equal(tio.load_gray(path), got)


def test_bmp_load_missing_and_bad(tmp_path):
    with pytest.raises(ValueError, match="cannot decode BMP"):
        tbmp.load_gray(str(tmp_path / "missing.bmp"))
    with pytest.raises(FileNotFoundError):
        tio.load_gray(str(tmp_path / "missing.bmp"))
    bad = tmp_path / "bad.bmp"
    bad.write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError):
        tbmp.load_gray(str(bad))
    with pytest.raises(ValueError):
        tio._bmp_gray(str(bad))


def _bmp_folder(tmp_path, n=6):
    rng = np.random.default_rng(11)
    paths, imgs = [], []
    for i in range(n):
        img = rng.integers(0, 256, (20 + i, 30 + 2 * i), np.uint8)
        p = str(tmp_path / f"img{i}.bmp")
        tbmp.save_gray(p, img)
        paths.append(p)
        imgs.append(img)
    return paths, imgs


def test_batch_loader_order(tmp_path):
    paths, imgs = _bmp_folder(tmp_path)
    paths.append(str(tmp_path / "missing.bmp"))
    with BatchLoader(paths, n_threads=3) as bl:
        for i in (5, 0, 3, 1, 4, 2):
            np.testing.assert_array_equal(bl.take(i), imgs[i])
        assert bl.take(6) is None
        with pytest.raises(IndexError):
            bl.take(7)
    with pytest.raises(ValueError, match="closed"):
        bl.take(0)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_file_source_takes_the_batch_loader(tmp_path, monkeypatch,
                                            n_threads):
    paths, imgs = _bmp_folder(tmp_path)
    made = []

    class Spy(BatchLoader):
        def __init__(self, p, n):
            made.append(n)
            super().__init__(p, n)

    monkeypatch.setattr("fastest_image_pattern_matching_tpu_torch.native."
                        "loader.BatchLoader", Spy)
    got = list(tsrc.FolderSource(str(tmp_path), n_threads=n_threads))
    assert made == [n_threads]
    for g, w in zip(got, imgs):
        np.testing.assert_array_equal(g, w)
    made.clear()
    with pytest.raises(ValueError, match="missing"):
        list(tsrc.FileSource(paths + [str(tmp_path / "missing.bmp")]))
    assert made == [4]


def test_fallback_without_compiler_is_counted(tmp_path, monkeypatch):
    """Without g++ (and nothing built), .bmp goes through the numpy twin,
    and each fallback is counted."""
    img = np.random.default_rng(4).integers(0, 256, (9, 14), np.uint8)
    monkeypatch.setattr(tbmp, "can_build", lambda: False)
    before = tbmp.FALLBACKS
    p = str(tmp_path / "f.bmp")
    tio.save_gray(p, img)
    np.testing.assert_array_equal(tio.load_gray(p), img)
    frames = list(tsrc.FileSource([p]))
    np.testing.assert_array_equal(frames[0], img)
    assert tbmp.FALLBACKS == before + 4
    with open(p, "rb") as f:
        assert f.read() == tio._bmp_gray_bytes(img)


def test_failed_build_raises_with_the_compilers_report(tmp_path,
                                                       monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_LIB", None)
    before = tbmp.FALLBACKS
    with pytest.raises(RuntimeError, match="error"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="error"):
        tbmp.available()
    assert tbmp.FALLBACKS == before  # a failed build is no fallback
    monkeypatch.setattr(native, "CXX", "no-such-compiler-fipm")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


@pytest.mark.parametrize("seed,k,tw,th,ov", [(0, 6, 10, 8, 0.25),
                                             (1, 9, 5, 7, 0.0),
                                             (2, 4, 13, 11, 0.6)])
def test_extract_peaks_vs_native_oracle(seed, k, tw, th, ov):
    lib = get_lib()
    score = np.random.default_rng(seed).random((45, 60)).astype(np.float32)
    vals, locs = extract_peaks(torch.from_numpy(score)[None], k, (tw, th),
                               ov)
    buf = score.copy()
    ox = (ctypes.c_int * k)()
    oy = (ctypes.c_int * k)()
    ovals = (ctypes.c_float * k)()
    n = lib.fipm_extract_peaks(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 45, 60, k, tw,
        th, ov, ox, oy, ovals)
    assert n == k
    for i in range(k):
        assert (int(locs[0, i, 0]), int(locs[0, i, 1])) == (ox[i], oy[i])
        assert float(vals[0, i]) == ovals[i]


@pytest.mark.parametrize("seed,max_overlap", [(5, 0.3), (6, 0.0), (7, 0.6)])
def test_filter_overlaps_vs_native_oracle(seed, max_overlap):
    lib = get_lib()
    rng = np.random.default_rng(seed)
    n = 16
    pts = torch.from_numpy(rng.uniform(0, 60, (n, 2)).astype(np.float32))
    angs = torch.from_numpy(rng.uniform(-180, 180, n).astype(np.float32))
    quads = rotated_rect_corners(pts, angs, 30.0, 18.0)
    valid = torch.from_numpy(rng.random(n) < 0.85)
    keep = filter_overlaps(quads.to(torch.float64), valid, 540.0,
                           max_overlap).numpy()
    q = quads.numpy().astype(np.float64).copy()
    alive = valid.numpy().astype(np.uint8)
    lib.fipm_filter_overlaps(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 540.0,
        max_overlap)
    np.testing.assert_array_equal(keep, alive.astype(bool))
    assert 0 < keep.sum() < valid.sum() or max_overlap == 0.6

