"""The port's batched serving path against the JAX package on the CPU:
match_many_arrays / match_many / BatchMatcher / match_patterns. The ops
that gained a frame axis and the one-phase run against the JAX package's
two-phase dispatch are in tests/test_torch_batch_ops.py.

Tolerances are the ROADMAP's: valid masks equal, score 1e-5, centre and
angle 1e-3 against JAX; the port's batch against its own match() to 1e-6
and 1e-5 (the same arithmetic); the ops exactly. The warp kernel's batched
form is held against its plain version on the card by
tests/test_torch_batch_card.py, which imports no JAX.
"""

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import batch as jbatch

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as ttm)
from fastest_image_pattern_matching_tpu_torch.utils import profiling
from tests.test_torch_match import _assert_same_result, _paste_rotated

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def _tol0_problem():
    """tests/test_batch.py's fixture: 4 frames of 200x260 at tol 0, three
    with the template planted, one empty."""
    rng = np.random.default_rng(11)
    tpl = rng.integers(0, 255, (24, 32), np.uint8)
    frames = []
    for k in range(3):
        f = rng.integers(0, 60, (200, 260), np.uint8)
        f[30 + 40 * k:54 + 40 * k, 50 + 30 * k:82 + 30 * k] = tpl
        frames.append(f)
    frames.append(rng.integers(0, 60, (200, 260), np.uint8))
    return np.stack(frames), tpl


def _rotated_problem():
    """3 frames of 200x240: the dry-run template of __graft_entry__ at 20
    and -15 deg on noise, and a blank frame of the border colour (no
    candidate survives there)."""
    t = np.full((40, 56), 30, np.uint8)
    cv2.rectangle(t, (4, 4), (51, 35), 200, 2)
    cv2.line(t, (8, 8), (48, 30), 255, 3)
    frames = []
    for k, a in enumerate((20.0, -15.0)):
        f = np.random.default_rng(20 + k).integers(0, 30, (200, 240),
                                                   np.uint8)
        _paste_rotated(f, t, 96.0, 80.0, a)
        frames.append(f)
    frames.append(np.full((200, 240), 255, np.uint8))
    return np.stack(frames), t


PROBLEMS = {
    "tol0": (_tol0_problem,
             dict(max_pos=5, score=0.8, tolerance_angle=0.0)),
    "tol30": (_rotated_problem,
              dict(max_pos=4, score=0.7, tolerance_angle=30.0)),
    # Score 0.02 keeps the noise peaks of the two noisy frames above the
    # NMS cap (128 of 189 candidates); the blank frame has none. Subpixel
    # is off: the fits of noise peaks are ill-conditioned (see
    # test_torch_match_configs' nms-overflow case), and without them
    # every entry is held to the standard tolerance.
    "tol30_overflow": (_rotated_problem,
                       dict(max_pos=16, score=0.02, tolerance_angle=30.0,
                            max_overlap=0.7, use_subpixel=False)),
}


@pytest.fixture(scope="module")
def problems():
    """Per problem: frames, template, JAX pattern, port pattern, config
    and JAX's match_many_arrays (computed once)."""
    out = {}
    for name, (make, kw) in PROBLEMS.items():
        frames, tpl = make()
        jp = jfipm.learn_pattern(tpl, 256)
        cfg = jfipm.MatchConfig(**kw)
        out[name] = (frames, tpl, jp, tfipm.pattern_from_reference(jp), cfg,
                     jbatch.match_many_arrays(frames, jp, cfg))
    return out


def _frame(out, i):
    return {k: v[i] for k, v in out.items()}


def _same_own(got, want):
    """The port's batch against its own single-frame run."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-6)
    v = want["valid"]
    for k in ("center", "angle"):
        np.testing.assert_allclose(got[k][v], want[k][v], atol=1e-5)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_match_many_arrays_vs_jax(problems, name):
    frames, _, _, tp, cfg, want = problems[name]
    got = tfipm.match_many_arrays(frames, tp, cfg, device="cpu")
    assert got["valid"].shape == want["valid"].shape
    for i in range(frames.shape[0]):
        _assert_same_result(_frame(got, i), _frame(want, i))
    if name == "tol0":
        assert got["valid"][:3].sum(axis=1).tolist() == [1, 1, 1]
        assert not got["valid"][3].any()
    if name == "tol30":
        assert got["valid"].sum(axis=1).tolist() == [1, 1, 0]


def counted_run(monkeypatch, fn):
    """fn() under the CPU profiler, with template_matcher._finalized's
    finalize spied on: fn's value, the number of fipm.sweep and
    fipm.descent spans, and each finalize's (nms_cap, overflow flags)."""
    finalizes = []
    real = ttm._finalized

    def spied(plan, finalize):
        def recorded(cap):
            packed = finalize(cap)
            finalizes.append((cap, (packed[:, -1, 0] > 0.5).tolist()))
            return packed
        return real(plan, recorded)
    monkeypatch.setattr(ttm, "_finalized", spied)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    names = [r.name for r in profiling.spans()]
    profiling.reset_spans()
    monkeypatch.setattr(ttm, "_finalized", real)
    return (out, names.count("fipm.sweep"), names.count("fipm.descent"),
            finalizes)


def test_overflow_frames_rerun_alone(problems, monkeypatch):
    """The overflow case really overflows in the two noisy frames and not
    in the blank one. The call sweeps and descends once; finalize runs
    capped, then once more with the cap lifted on the same candidates."""
    frames, _, _, tp, cfg, _ = problems["tol30_overflow"]
    plan = ttm._make_plan(frames.shape[1:], tp, cfg)
    assert plan.nms_cap < plan.c_max
    got, sweeps, descents, finalizes = counted_run(
        monkeypatch,
        lambda: tfipm.match_many_arrays(frames, tp, cfg, device="cpu"))
    assert (sweeps, descents) == (1, 1)
    assert finalizes == [(None, [True, True, False]),
                         (plan.c_max, [False, False, False])]
    assert got["valid"][:2].all()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_match_many_equals_match(problems, name):
    """The per-frame contract of tests/test_batch.py: match_many[i] equals
    match(frame i), as arrays and as MatchResult lists."""
    frames, _, _, tp, cfg, _ = problems[name]
    got = tfipm.match_many_arrays(frames, tp, cfg, device="cpu")
    lists = tfipm.match_many(frames, tp, cfg, device="cpu")
    for i in range(frames.shape[0]):
        want = tfipm.match_arrays(frames[i], tp, cfg, device="cpu")
        _same_own(_frame(got, i), want)
        one = tfipm.match(frames[i], tp, cfg, device="cpu")
        assert [(r.score, r.center, r.angle) for r in lists[i]] == \
            [(r.score, r.center, r.angle) for r in one]


def test_match_many_tensor_input(problems):
    """A tensor batch (f32 or u8; on the card it is used without a copy)
    gives the numpy batch's results; BatchMatcher too."""
    frames, _, _, tp, cfg, _ = problems["tol0"]
    want = tfipm.match_many_arrays(frames, tp, cfg, device="cpu")
    for t in (torch.as_tensor(frames), torch.as_tensor(frames).float()):
        got = tfipm.match_many_arrays(t, tp, cfg, device="cpu")
        for i in range(frames.shape[0]):
            _same_own(_frame(got, i), _frame(want, i))
    bm = tfipm.BatchMatcher(tp, cfg, batch_size=4, device="cpu")
    bm.warmup(frames.shape[1:])
    for a, b in zip(bm.match_batch(frames),
                    tfipm.match_many(frames, tp, cfg, device="cpu")):
        assert [(r.score, r.center) for r in a] == \
            [(r.score, r.center) for r in b]


@pytest.mark.parametrize("case", ["u8", "shape", "bucket", "larger"])
def test_match_many_input_checks(problems, case):
    frames, _, _, tp, cfg, _ = problems["tol0"]
    kw, match = {}, None
    if case == "u8":
        bad = frames.astype(np.float32)
        bad[0, 0, 0] = 300.0
        args, match = (bad, tp, cfg), "0, 255"
    elif case == "shape":
        args, match = (frames[0], tp, cfg), "B, H, W"
    elif case == "bucket":
        args, kw, match = (frames, tp, cfg), dict(batch_bucket=2), "< batch"
    else:
        args, match = (frames[:, :20, :20], tp, cfg), "larger than source"
    with pytest.raises(ValueError, match=match):
        tfipm.match_many_arrays(*args, device="cpu", **kw)
    # 4-D colour frames go through ensure_gray.
    colour = np.repeat(frames[..., None], 3, axis=-1)
    got = tfipm.match_many_arrays(colour, tp, cfg, device="cpu")
    assert got["valid"].shape == (4, cfg.max_pos)


def test_match_patterns_vs_jax(problems):
    """Two same-shaped patterns and one of another shape: two groups,
    results in input order, each equal to JAX's match_patterns and to the
    port's own match_arrays."""
    frames, tpl, jp, tp, cfg, _ = problems["tol0"]
    other = np.random.default_rng(12).integers(0, 255, (18, 26), np.uint8)
    jps = [jp, jfipm.learn_pattern(tpl[::-1].copy(), 256),
           jfipm.learn_pattern(other, 256)]
    tps = [tfipm.pattern_from_reference(p) for p in jps]
    want = jbatch.match_patterns(frames[1], jps, cfg)
    got = tfipm.match_patterns(frames[1], tps, cfg, device="cpu")
    assert len(got) == 3
    for g, w, p in zip(got, want, tps):
        _assert_same_result(g, w)
        _same_own(g, tfipm.match_arrays(frames[1], p, cfg, device="cpu"))
    assert got[0]["valid"].sum() == 1
