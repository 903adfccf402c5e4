"""The port's multi-template (OCR) path, corpus inspection and BMP loading
against the JAX package on the CPU.

MultiTemplateMatcher.match_all against JAX's on a glyph plate built from
chip_smoke.py's 5x7 dot-matrix font (batched, per glyph, with and without
the cross-template NMS), the port's float64 cross-template NMS against
JAX's, which runs the C++ greedy of the JAX package's native library,
read_string, inspect_corpus with a straggler, and load_gray against JAX's
native BMP decoder. Tolerances as in tests/test_torch_batch.py.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import corpus as jcorpus
from fastest_image_pattern_matching_tpu.models import multi_template as jmt
from fastest_image_pattern_matching_tpu.native import get_lib as jax_get_lib
from fastest_image_pattern_matching_tpu.types import MatchResult as JResult
from fastest_image_pattern_matching_tpu.utils import imageio as jio

import chip_smoke
import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import corpus as tcorpus
from fastest_image_pattern_matching_tpu_torch.native import get_lib
from fastest_image_pattern_matching_tpu_torch.models import (
    multi_template as tmt)
from fastest_image_pattern_matching_tpu_torch.types import MatchResult
from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

GLYPHS = "0123456789AB"
TEXT = "B1A07"


@pytest.fixture(scope="module")
def plate():
    """A 120x320 plate with TEXT stamped in 52x34 glyphs, the twelve
    glyphs learned by both packages (OCR configuration of
    tools/ocr_bench.py)."""
    scene, placed = chip_smoke.ocr_plate(TEXT, hw=(120, 320), x0=16, y0=34)
    cfg = chip_smoke.ocr_config(jfipm)
    jm = jmt.MultiTemplateMatcher(cfg)
    tm = tmt.MultiTemplateMatcher(cfg, device="cpu")
    for ch in GLYPHS:
        jm.learn(ch, chip_smoke.glyph(ch))
        tm.learn(ch, chip_smoke.glyph(ch))
    return scene, placed, cfg, jm, tm


def _same_labeled(got, want, atol_score, atol_pos):
    assert [m.label for m in got] == [m.label for m in want]
    for a, b in zip(got, want):
        assert abs(a.result.score - b.result.score) <= atol_score
        assert abs(a.result.pos_x - b.result.pos_x) <= atol_pos
        assert abs(a.result.pos_y - b.result.pos_y) <= atol_pos
        assert abs(a.result.angle - b.result.angle) <= atol_pos


@pytest.mark.parametrize("cross_nms", [False, True])
def test_match_all_vs_jax(plate, cross_nms):
    scene, placed, cfg, jm, tm = plate
    assert jax_get_lib() is not None  # JAX's cross-template NMS runs its C++
    want = jm.match_all(scene, cross_nms=cross_nms, batched=True)
    got = tm.match_all(scene, cross_nms=cross_nms, batched=True)
    _same_labeled(got, want, 1e-5, 1e-3)
    assert tmt.read_string(got, cfg.score) == TEXT
    for (ch, cx, cy), m in zip(placed, sorted(
            [m for m in got if m.result.score >= 0.99],
            key=lambda m: m.result.pos_x)):
        assert m.label == ch
        assert abs(m.result.pos_x - cx) < 1.0
        assert abs(m.result.pos_y - cy) < 1.0


def test_match_all_batched_equals_per_glyph(plate):
    scene, _, cfg, _, tm = plate
    batched = tm.match_all(scene, batched=True)
    looped = tm.match_all(scene, batched=False)
    _same_labeled(batched, looped, 1e-6, 1e-5)
    assert tmt.read_string(looped, cfg.score) == TEXT


@pytest.mark.parametrize("max_overlap", [0.0, 0.3, 0.6])
def test_cross_nms_vs_native(max_overlap):
    """The port's cross-template NMS (ops/nms.py in float64) against the
    JAX package's, which calls the C++ greedy of its native library
    (native/src/fipm_native.cc), and against the same greedy in the port's
    own copy of that library: the same survivors."""
    assert jax_get_lib() is not None
    rng = np.random.default_rng(int(max_overlap * 10) + 3)
    n = 40
    pts = rng.uniform(0, 120, (n, 2))
    ang = rng.uniform(-180, 180, n)
    size = rng.uniform(20, 40, (n, 2))
    scores = np.sort(rng.uniform(0.5, 1.0, n))[::-1]
    jl, tl = [], []
    for (x, y), a, (w, h), s in zip(pts, ang, size, scores):
        c, si = np.cos(np.radians(a)), np.sin(np.radians(a))
        lt = (float(x), float(y))
        rt = (x + w * c, y - w * si)
        lb = (x + h * si, y + h * c)
        rb = (rt[0] + h * si, rt[1] + h * c)
        corners = [tuple(map(float, p)) for p in (lt, rt, rb, lb)]
        centre = tuple(np.mean(corners, axis=0).tolist())
        kw = dict(score=float(s), angle=float(a), center=centre,
                  lt=corners[0], rt=corners[1], rb=corners[2],
                  lb=corners[3])
        jl.append(jmt.LabeledMatch(f"g{len(jl)}", JResult(**kw)))
        tl.append(tmt.LabeledMatch(f"g{len(tl)}", MatchResult(**kw)))
    cfg = jfipm.MatchConfig(max_overlap=max_overlap)
    want = jmt.MultiTemplateMatcher(cfg)._cross_nms(jl)
    got = tmt.MultiTemplateMatcher(cfg, device="cpu")._cross_nms(tl)
    assert [m.label for m in got] == [m.label for m in want]
    assert 0 < len(got) < n
    quads = np.array([[m.result.lt, m.result.rt, m.result.rb, m.result.lb]
                      for m in tl], np.float64)
    areas = [abs(np.linalg.norm(np.subtract(m.result.rt, m.result.lt))
                 * np.linalg.norm(np.subtract(m.result.lb, m.result.lt)))
             for m in tl]
    alive = np.ones(n, np.uint8)
    get_lib().fipm_filter_overlaps(
        quads.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        float(np.median(areas)), max_overlap)
    assert [m.label for m, a in zip(tl, alive) if a] == [m.label
                                                          for m in got]


def test_read_string_anchor_does_not_chain():
    """tests/test_corpus.py's anchor case on the port's read_string."""
    def m(label, x, score):
        r = MatchResult(score=score, angle=0.0, center=(x, 10.0),
                        lt=(x - 5, 5), rt=(x + 5, 5), rb=(x + 5, 15),
                        lb=(x - 5, 15))
        return tmt.LabeledMatch(label, r)

    ms = [m("A", 0.0, 0.9), m("B", 13.0, 0.9), m("C", 26.0, 0.9),
          m("D", 39.0, 0.9)]
    assert tmt.read_string(ms, 0.5, x_merge=12.0) == "ABCD"
    ms2 = [m("A", 0.0, 0.8), m("a", 10.0, 0.95), m("B", 13.0, 0.9)]
    assert tmt.read_string(ms2, 0.5, x_merge=12.0) == "aB"


def test_inspect_corpus_vs_jax_with_straggler():
    """Four equal frames in batches of 2 and a straggler of another shape
    in a batch of its own: per-frame results equal to JAX's inspect_corpus
    (mesh=None) and reports in order."""
    templ = chip_smoke.stream_template()
    frames, centres = chip_smoke.stream_frames(templ, 4, hw=(180, 240))
    straggler, s_centre = chip_smoke.stream_frames(templ, 1, hw=(160, 220),
                                                   seed=6)
    corpus = list(frames) + [straggler[0]]
    jp = jfipm.learn_pattern(templ, 256)
    cfg = jfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=0.0)
    want = list(jcorpus.inspect_corpus(iter(corpus), jp, cfg, batch_size=2))
    got = list(tcorpus.inspect_corpus(iter(corpus),
                                      tfipm.pattern_from_reference(jp), cfg,
                                      batch_size=2, device="cpu"))
    assert [r.index for r in got] == list(range(5))
    for g, w, c in zip(got, want, centres + s_centre):
        assert len(g.results) == len(w.results) >= 1
        for a, b in zip(g.results, w.results):
            assert abs(a.score - b.score) <= 1e-5
            assert abs(a.pos_x - b.pos_x) <= 1e-3
            assert abs(a.pos_y - b.pos_y) <= 1e-3
        assert abs(g.results[0].pos_x - c[0]) < 1.0
        assert g.execution_ms > 0


def _write_bmp(path, img, bpp, top_down, palette=None):
    """An uncompressed BMP written by hand: 8-bit with `palette` ([256, 3]
    RGB, img holds indices), or 24/32-bit with img [h, w, 3] in BGR."""
    h, w = img.shape[:2]
    bypp = bpp // 8
    stride = (w * bypp + 3) & ~3
    pal = b"" if bpp != 8 else b"".join(
        bytes([b, g, r, 0]) for r, g, b in palette)
    off = 54 + len(pal)
    rows = img if top_down else img[::-1]
    data = b""
    for row in rows:
        if bpp == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            px = np.concatenate([row, np.zeros((w, bypp - 3), np.uint8)], 1)
            raw = px.astype(np.uint8).tobytes()
        data += raw + b"\0" * (stride - len(raw))
    header = struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, len(data), 2835, 2835, 256 if bpp == 8 else 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + pal + data)


@pytest.mark.parametrize("kind", ["save_gray", "pal8_top_down",
                                  "bgr24_bottom_up", "bgr32_top_down",
                                  "png"])
def test_load_gray_vs_jax(tmp_path, kind):
    """load_gray against JAX's: its BMPs come from JAX's save_gray (8-bit
    grey palette) or are written here (a colour palette, 24 and 32 bits,
    both row orders), decoded by the native codec on the JAX side; PNG
    through PIL on the port's side and cv2 on JAX's."""
    rng = np.random.default_rng(10)
    gray = rng.integers(0, 256, (23, 37), np.uint8)
    path = str(tmp_path / ("img.png" if kind == "png" else "img.bmp"))
    if kind in ("save_gray", "png"):
        jio.save_gray(path, gray)
    elif kind == "pal8_top_down":
        palette = rng.integers(0, 256, (256, 3))
        _write_bmp(path, gray, 8, True, palette)
    else:
        colour = rng.integers(0, 256, (23, 37, 3), np.uint8)
        _write_bmp(path, colour, 24 if "24" in kind else 32,
                   "top_down" in kind)
    got = tio.load_gray(path)
    want = jio.load_gray(path)
    assert got.dtype == np.uint8 and got.shape == (23, 37)
    np.testing.assert_array_equal(got, want)
    if kind in ("save_gray", "png"):
        np.testing.assert_array_equal(got, gray)


def test_load_gray_without_pil_names_the_format(tmp_path, monkeypatch):
    """Without PIL a JPEG raises an ImportError naming its extension and
    PIL; a PNG, which the port's own reader decodes, loads."""
    jpg, png = str(tmp_path / "img.jpg"), str(tmp_path / "img.png")
    jio.save_gray(jpg, np.zeros((4, 4), np.uint8))
    jio.save_gray(png, np.full((4, 4), 7, np.uint8))
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.jpg images needs PIL"):
        tio.load_gray(jpg)
    np.testing.assert_array_equal(tio.load_gray(png),
                                  np.full((4, 4), 7, np.uint8))
    with pytest.raises(FileNotFoundError):
        tio.load_gray(str(tmp_path / "missing.bmp"))


def test_learn_glyph_dir_reads_bmp_glyphs(tmp_path, plate):
    """Glyph BMPs written by JAX's save_gray, learned by the port from the
    directory: the same pyramids as learned from the arrays, and the
    plate reads back."""
    scene, _, cfg, _, tm = plate
    for ch in GLYPHS:
        jio.save_gray(str(tmp_path / f"{ch}.bmp"), chip_smoke.glyph(ch))
    (tmp_path / "notes.txt").write_text("not a glyph")
    m = tmt.MultiTemplateMatcher(cfg, device="cpu")
    m.learn_glyph_dir(str(tmp_path))
    assert sorted(m.patterns) == sorted(GLYPHS)
    for ch in GLYPHS:
        np.testing.assert_array_equal(m.patterns[ch].levels[-1].templ,
                                      tm.patterns[ch].levels[-1].templ)
    assert tmt.read_string(m.match_all(scene), cfg.score) == TEXT
    got = tmt.match_glyphs(scene, str(tmp_path), cfg, device="cpu")
    assert tmt.read_string(got, cfg.score) == TEXT
