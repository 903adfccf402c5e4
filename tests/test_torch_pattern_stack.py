"""A plan group's patterns as one stacked pipeline (models/batch.py::
_match_group: build_stages with a StackLevel a level, the pattern the row
axis of every stage) against the same patterns run one by one.

On the CPU, both sides on the plain routes, match_patterns equals
match_arrays of each pattern bit for bit:
- on the benchmark's glyph plates at the small size of
  tests/test_torch_ocr_reference.py (seeds 0-2);
- on a glyph set of two template sizes (two plan groups);
- on a group of flat templates beside a group of glyphs;
- on a glyph with a fractional level, which groups apart;
- on a group whose patterns overflow the NMS cap (the uncapped rerun of
  the whole group).
Under the profiler a group runs one sweep (one correlation, one peak
extraction), one descent and one finalize, every pattern counts as
stacked, and one match call opens the spans it opened before patterns
were stacked. Tests marked `cuda` hold the stacked path on the card
against per-pattern runs on the card, one descent-score launch a chunk,
and skip without one. Imports nothing of JAX:

    python3 -m pytest --noconftest tests/test_torch_pattern_stack.py
"""

import collections
import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import batch
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as tm)
from fastest_image_pattern_matching_tpu_torch.ops import ncc
from fastest_image_pattern_matching_tpu_torch.utils import profiling
from fipm_bench import program, run
from fipm_bench.scenes import glyph_plate

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower.
torch.set_num_threads(1)

with open(os.path.join(run.BENCH_DIR, "configs", "ocr.json")) as f:
    CONFIG = json.load(f)
# tests/test_torch_ocr_reference.py's plates: 10 glyphs, look-alikes
# among them, 4 stamped on a 120x320 plate.
SMALL = dict(CONFIG["scene_params"], frame_hw=[120, 320],
             glyphs="0O8B1IMX25", length=4, first=None, y0=34)
SEEDS = (0, 1, 2)
OCR_CFG = tfipm.MatchConfig(**CONFIG["match"])


def _learn(templs, cfg, device="cpu"):
    return [tfipm.learn_pattern(t, cfg.min_reduce_area, device=device)
            for t in templs]


def _same_bits(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), k


def _hold(src, patterns, cfg, device="cpu"):
    """match_patterns against match_arrays of each pattern, bit for bit;
    returns match_patterns' results."""
    got = tfipm.match_patterns(src, patterns, cfg, device=device)
    assert len(got) == len(patterns)
    for g, p in zip(got, patterns):
        _same_bits(g, tm.match_arrays(src, p, cfg, device=device))
    return got


def _plate(seed):
    glyphs, frames, truths = glyph_plate.make_pool(SMALL, 1, 0,
                                                   run.seed_rng(seed))
    return glyphs, frames[0], truths[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_glyph_plates_equal_per_pattern(seed):
    glyphs, plate, truth = _plate(seed)
    pats = _learn(glyphs.values(), OCR_CFG)
    assert len(batch._pattern_groups(pats)) == 1
    got = _hold(plate, pats, OCR_CFG)
    found = {ch for ch, g in zip(glyphs, got) if g["valid"].any()}
    assert set(truth) <= found


def _two_sizes():
    """A plate with "0B1O" stamped at 52x34 and "8I25" at 40x26 below it,
    and those eight glyphs at both sizes: two plan groups (the two sizes
    have other pyramids)."""
    rng = np.random.default_rng(5)
    plate, _ = glyph_plate.stamp("0B1O", rng, (200, 320), (52, 34), 30, 20)
    small, _ = glyph_plate.stamp("8I25", rng, (70, 320), (40, 26), 30, 15)
    plate[120:190] = small
    chars = "0B1O8I25"
    templs = [glyph_plate.glyph(c, hw) for hw in ((52, 34), (40, 26))
              for c in chars]
    return plate, templs


def test_two_plan_groups_equal_per_pattern():
    plate, templs = _two_sizes()
    pats = _learn(templs, OCR_CFG)
    groups = batch._pattern_groups(pats)
    assert sorted(len(g) for g in groups.values()) == [8, 8]
    got = _hold(plate, pats, OCR_CFG)
    assert sum(g["valid"].any() for g in got[:8]) >= 4
    assert sum(g["valid"].any() for g in got[8:]) >= 4


def test_flat_template_group_equals_per_pattern():
    """Flat templates (every level flat: all-ones score maps, the flat
    descent) of one border colour form a group of their own beside the
    glyphs' group."""
    glyphs, plate, _ = _plate(0)
    templs = list(glyphs.values())[:4] + [
        np.full((52, 34), v, np.uint8) for v in (200, 170)]
    pats = _learn(templs, OCR_CFG)
    assert all(lv.result_equal1 for p in pats[4:] for lv in p.levels)
    groups = batch._pattern_groups(pats)
    assert sorted(groups.values()) == [[0, 1, 2, 3], [4, 5]]
    got = _hold(plate, pats, OCR_CFG)
    assert got[4]["valid"].any() and got[5]["valid"].any()


def test_non_u8_template_groups_apart():
    """A pattern with a fractional level is off the descent-score kernel's
    integer route: it forms a group of its own, so the other patterns of
    its plan keep a stack whose every template is u8-valued."""
    glyphs, plate, _ = _plate(0)
    pats = _learn(list(glyphs.values())[:4], OCR_CFG)
    lv = pats[3].levels[0]
    t = lv.templ.copy()
    t[0, 0] += 0.5
    pats[3] = dataclasses.replace(
        pats[3], levels=[dataclasses.replace(lv, templ=t)]
        + list(pats[3].levels[1:]))
    groups = batch._pattern_groups(pats)
    assert sorted(groups.values()) == [[0, 1, 2], [3]]
    assert all(st.u8_valued for st in tm._stack_inputs(pats[:3], "cpu")[0])
    _hold(plate, pats, OCR_CFG)


def _rotated_part():
    """tests/test_torch_batch.py's rotated part: a 40x56 frame and bar."""
    t = np.full((40, 56), 30, np.uint8)
    cv2.rectangle(t, (4, 4), (51, 35), 200, 2)
    cv2.line(t, (8, 8), (48, 30), 255, 3)
    return t


def test_overflow_reruns_the_group_uncapped(monkeypatch):
    """tests/test_torch_batch.py's overflow settings (score 0.02 keeps
    noise peaks above the NMS cap) on a part and its mirror, one group:
    the group is finalized capped, flags an overflow, and is finalized
    once more uncapped on the same candidates; each pattern still equals
    its own run, which reruns alone."""
    t = _rotated_part()
    frame = np.random.default_rng(20).integers(0, 30, (200, 240), np.uint8)
    frame[60:100, 70:126] = t
    cfg = tfipm.MatchConfig(max_pos=16, score=0.02, tolerance_angle=30.0,
                            max_overlap=0.7, use_subpixel=False)
    pats = _learn([t, t[:, ::-1].copy()], cfg)
    plan = tm._make_plan(frame.shape, pats[0], cfg)
    assert plan.nms_cap < plan.c_max
    calls = []
    real = batch._finalized

    def spy(plan, finalize):
        def counted(cap):
            packed = finalize(cap)
            calls.append((cap, (packed[:, -1, 0] > 0.5).tolist()))
            return packed
        return real(plan, counted)

    monkeypatch.setattr(batch, "_finalized", spy)
    _hold(frame, pats, cfg)
    assert [c[0] for c in calls] == [None, plan.c_max]
    assert any(calls[0][1]) and not any(calls[1][1])


def _traced(fn):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    rows = profiling.spans()
    profiling.reset_spans()
    return out, rows


def test_spans_and_counters_a_group():
    """Each group: one fipm.sweep (one correlation and one peak
    extraction in it), one fipm.descent, one fipm.finalize, and its
    candidates and its finalize each one fipm.patterns.pattern; every
    pattern counted in patterns.run and patterns.stacked."""
    plate, templs = _two_sizes()
    pats = _learn(templs, OCR_CFG)
    plain = tfipm.match_patterns(plate, pats, OCR_CFG, device="cpu")
    got, rows = _traced(
        lambda: tfipm.match_patterns(plate, pats, OCR_CFG, device="cpu"))
    for g, p in zip(got, plain):
        _same_bits(g, p)
    names = collections.Counter(r.name for r in rows)
    groups = program.counts(rows, "patterns.groups")
    assert groups == 2
    for name in ("fipm.sweep", "fipm.sweep.chunk", "fipm.peaks",
                 "fipm.descent", "fipm.finalize", "fipm.nms"):
        assert names[name] == groups, name
    sweep_ncc = [r for r in rows if r.name == "fipm.ncc.corr"
                 and rows[rows[r.parent].parent].name == "fipm.sweep.chunk"]
    assert len(sweep_ncc) == groups
    assert names["fipm.patterns.pattern"] == 2 * groups
    assert program.counts(rows, "patterns.run") == len(pats)
    assert program.counts(rows, "patterns.stacked") == len(pats)


# The spans of one match call (the rotated part at 30 deg tolerance on a
# 200x240 frame) as they were before the template axis was stacked.
MATCH_SPANS = {
    "fipm.descent": 1, "fipm.descent.L0": 1, "fipm.descent.L1": 1,
    "fipm.descent.best": 2, "fipm.descent.chunk": 2, "fipm.descent.maps": 2,
    "fipm.descent.pick": 2, "fipm.descent.subpixel": 1,
    "fipm.descent.warp": 2, "fipm.finalize": 1, "fipm.finalize.pick": 1,
    "fipm.join": 2, "fipm.match": 1, "fipm.ncc": 3, "fipm.ncc.corr": 3,
    "fipm.ncc.score": 3, "fipm.ncc.sums": 3, "fipm.nms": 1,
    "fipm.nms.area": 1, "fipm.nms.clip": 4, "fipm.nms.greedy": 1,
    "fipm.peaks": 1, "fipm.peaks.round": 7, "fipm.prepare": 1,
    "fipm.pyramid": 1, "fipm.readback": 1, "fipm.results": 1,
    "fipm.select": 2, "fipm.sweep": 1, "fipm.sweep.chunk": 1,
    "fipm.upload": 1,
}


def test_one_match_opens_the_spans_it_opened():
    t = _rotated_part()
    frame = np.random.default_rng(20).integers(0, 30, (2, 200, 240),
                                               np.uint8)[0]
    frame[60:100, 70:126] = t
    cfg = tfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=30.0,
                            max_overlap=0.3)
    p = tfipm.learn_pattern(t, cfg.min_reduce_area, device="cpu")
    stacked = profiling.counter("patterns.stacked")
    res, rows = _traced(lambda: tfipm.match(frame, p, cfg, device="cpu"))
    assert len(res) == 1 and res[0].score > 0.9
    assert dict(collections.Counter(r.name for r in rows)) == MATCH_SPANS
    assert profiling.counter("patterns.stacked") == stacked


def test_stack_inputs_one_copy_a_group(monkeypatch):
    """A group's templates and constants tables reach the device in one
    copy; each level's table holds score_constants of each pattern."""
    glyphs, _, _ = _plate(1)
    pats = _learn(list(glyphs.values())[:5], OCR_CFG)
    copies = []
    real = torch.Tensor.to

    def spy(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    stats, templs = tm._stack_inputs(pats, "cpu")
    monkeypatch.setattr(torch.Tensor, "to", real)
    assert len(copies) == 1
    for l, (st, t) in enumerate(zip(stats, templs)):
        h, w = pats[0].levels[l].templ.shape
        assert t.shape == (5, h, w) and st.consts.shape == (5, 6)
        for g, p in enumerate(pats):
            lv = p.levels[l]
            assert np.array_equal(t[g].numpy(), lv.templ)
            assert st.consts[g].tolist() == list(ncc.score_constants(
                lv.mean, lv.norm, lv.inv_area, float(h * w)))
        assert st.u8_valued and not st.result_equal1


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 2654435761])
def test_benchmark_plate_on_card_equals_per_pattern(cuda_device,
                                                    monkeypatch, seed):
    """The benchmark's plate (360x640, 36 glyphs of 52x34, one group) on
    the card: match_patterns equals per-pattern match_arrays on the card
    bit for bit, and every stacked descent chunk is one launch of the
    descent-score kernel with the template index."""
    glyphs, frames, truths = glyph_plate.make_pool(
        CONFIG["scene_params"], 1, 0, run.seed_rng(seed))
    pats = _learn(glyphs.values(), OCR_CFG, cuda_device)
    chunks = []

    def spy(*args):
        chunks.append(args[-1])
        return ncc.descent_best_stack(*args)

    monkeypatch.setattr(tm, "descent_best_stack", spy)
    before = profiling.counter("descent_score.launches")
    got = tfipm.match_patterns(frames[0], pats, OCR_CFG, device=cuda_device)
    launched = profiling.counter("descent_score.launches") - before
    assert launched == len(chunks) > 0 and all(chunks)
    for g, p in zip(got, pats):
        _same_bits(g, tm.match_arrays(frames[0], p, OCR_CFG,
                                      device=cuda_device))
    found = {ch for ch, g in zip(glyphs, got) if g["valid"].any()}
    assert set(truths[0]) <= found
