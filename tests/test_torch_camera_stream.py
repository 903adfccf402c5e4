"""The camera stream of the benchmark's `corpus` configuration on the CPU:
BGR24 frames through the port's every-frame VideoCaptureSource (the
grabber thread and its FIFO) into inspect_corpus, against the plain
reference (fipm_bench/reference/camera.py) at a small size; the grey
conversion against cv2; the grabber's order, read-ahead, ends, stalls
and close; inspect_corpus's flush of a full batch; the spans and
counters of the stream; and the reference's imports.

The small size keeps the configuration's settings (the Qt dialog's
defaults) and scales its scene down: 240x320 frames, a 30x40 part at 3
poses, batch 4, the FIFO 3 frames deep. The part's plan still descends
(top layer 2) at several angles a candidate.
"""

import json
import os
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import corpus
from fastest_image_pattern_matching_tpu_torch.utils import profiling
from fastest_image_pattern_matching_tpu_torch.utils.imageio import (
    ensure_gray)
from fastest_image_pattern_matching_tpu_torch.utils.sources import (
    VideoCaptureSource)
from fipm_bench import program, run
from fipm_bench.reference import camera as ref

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower.
torch.set_num_threads(1)

ROOT = os.path.dirname(run.BENCH_DIR)
with open(os.path.join(run.BENCH_DIR, "configs", "corpus.json")) as f:
    CONFIG = json.load(f)
_SP = CONFIG["scene_params"]
SMALL = dict(
    _SP, frame_hw=[240, 320],
    template=dict(_SP["template"], hw=[30, 40], shapes=[
        {"disc": [14, 12, 8], "val": 230},
        {"box": [24, 4, 30, 26], "val": 20},
        {"box": [4, 20, 20, 28], "val": 180}]),
    poses=[[159.5, 119.5, 12.5], [234.5, 119.5, -170.0],
           [84.5, 119.5, 77.0]])
SMALL_CONFIG = dict(CONFIG, scene_params=SMALL)
SEEDS = (0, 3)
BATCH = 4


def bench_module(kind, name):
    return run.load_module(os.path.join(run.BENCH_DIR, kind, name + ".py"))


def grabbers():
    return [t for t in threading.enumerate()
            if t.name == "fipm-grab" and t.is_alive()]


@pytest.fixture(scope="module")
def cases():
    """Per seed: the pool's truths, the port's answers for one batch
    through the benchmark's entry (its in-process camera, the every-frame
    source with a FIFO of 3 in place of 16), the reference's answers and
    the control's."""
    scene = bench_module("scenes", "camera_parts")
    setup = bench_module("setups", "template")
    entry = bench_module("entries", "camera_stream")
    out = {}
    for seed in SEEDS:
        templ, pool, truths = scene.make_pool(SMALL, BATCH, 1,
                                              run.seed_rng(seed))
        learned = setup.learn(tfipm, SMALL_CONFIG, templ, "cpu")
        assert learned.pattern.top_layer > 0
        ctx = run.Context(tfipm, learned, setup.rows, pool, "cpu",
                          {"frames_per_call": BATCH, "queue_frames": 3}, "",
                          [], run.BENCH_DIR)
        call = entry.prepare(ctx)
        port = call(0)
        del call
        idx = [i for i, _ in port]
        out[seed] = {
            "truths": truths, "port": port,
            "reference": {i: ref.answer(pool[i], templ, SMALL_CONFIG, "cpu")
                          for i in idx},
            "control": [(i, ref.answer(pool[i], templ, SMALL_CONFIG, "cpu",
                                       **CONFIG["controls"]["bf16_scores"]))
                        for i in idx]}
    assert not grabbers()
    return out


def judge(answers, reference):
    return bench_module("comparisons", "match_lists").judge(
        answers, reference, CONFIG["limits"])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_within_the_limits_of_the_reference(cases, seed):
    c = cases[seed]
    assert [i for i, _ in c["port"]] == list(range(BATCH))
    verdict = judge(c["port"], c["reference"])
    assert verdict["correct"], verdict["numbers"]
    # Every part found, none in the empty tray.
    assert [len(r) for _, r in c["port"]] == [len(t) for t in c["truths"]]


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_scores_control_breaks_a_limit(cases, seed):
    c = cases[seed]
    verdict = judge(c["control"], c["reference"])
    assert not verdict["correct"], verdict["numbers"]


def test_grey_equals_cvtcolor():
    rng = np.random.default_rng(11)
    for shape in ((7, 9, 3), (240, 320, 3)):
        bgr = rng.integers(0, 256, shape, np.uint8)
        want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(ref.grey(bgr), want)
        np.testing.assert_array_equal(ensure_gray(bgr), want)


class NumberedCap:
    """A capture device whose i-th read (from 1) is a frame filled with
    i % 256; BGR when `colour`. `fail_at` raises at that read, `stall`
    blocks every read until it is set, `delay` sleeps before each read."""

    def __init__(self, n_frames=100, colour=False, fail_at=0, stall=None,
                 delay=0.0):
        self.n_frames = n_frames
        self.colour = colour
        self.fail_at = fail_at
        self.stall = stall
        self.delay = delay
        self.reads = 0
        self.released = False

    def isOpened(self):
        return True

    def read(self):
        if self.stall is not None:
            self.stall.wait(10)
        if self.delay:
            time.sleep(self.delay)
        if self.reads >= self.n_frames:
            return False, None
        self.reads += 1
        if self.reads == self.fail_at:
            raise OSError(f"device lost at read {self.reads}")
        shape = (6, 8, 3) if self.colour else (6, 8)
        return True, np.full(shape, self.reads % 256, np.uint8)

    def set(self, prop, value):
        return True

    def get(self, prop):
        return 0.0

    def release(self):
        self.released = True


def _source(cap, **kw):
    return VideoCaptureSource(0, cap_factory=lambda _: cap, **kw)


def test_every_frame_in_order_none_lost_beyond_the_queue():
    cap = NumberedCap(n_frames=40)
    src = _source(cap, latest_only=False, queue_frames=4)
    got = []
    for f in src.frames():
        got.append(int(f[0, 0]))
        if len(got) % 5 == 0:
            time.sleep(0.01)
    assert got == list(range(1, 41))
    assert src.frame_count == 40 and cap.released
    assert not grabbers()


def test_grabber_reads_at_most_the_queue_plus_one_ahead():
    cap = NumberedCap(n_frames=30)
    src = _source(cap, latest_only=False, queue_frames=3)
    ahead = []
    for n, f in enumerate(src.frames(), 1):
        time.sleep(0.02)                  # the grabber fills the FIFO
        ahead.append(cap.reads - n)
    assert max(ahead) <= 3 + 1, ahead
    assert max(ahead) >= 3, ahead         # it does read ahead
    assert not grabbers()


def test_colour_frames_arrive_grey():
    src = _source(NumberedCap(n_frames=3, colour=True), latest_only=False)
    got = list(src.frames())
    assert [f.shape for f in got] == [(6, 8)] * 3
    assert [int(f[0, 0]) for f in got] == [1, 2, 3]


def test_a_failed_read_and_the_end_surface_at_their_frame():
    src = _source(NumberedCap(fail_at=6), latest_only=False, queue_frames=2)
    got = []
    with pytest.raises(OSError, match="read 6"):
        for f in src.frames():
            got.append(int(f[0, 0]))
    assert got == [1, 2, 3, 4, 5]
    src = _source(NumberedCap(n_frames=7), latest_only=False, queue_frames=2)
    assert [int(f[0, 0]) for f in src.frames()] == list(range(1, 8))
    assert not grabbers()


def test_a_stalled_device_raises_after_the_timeout():
    stall = threading.Event()
    src = _source(NumberedCap(stall=stall), latest_only=False,
                  timeout_s=0.2)
    t0 = time.perf_counter()
    try:
        with pytest.raises(TimeoutError, match="frame 0"):
            next(src.frames())
        assert time.perf_counter() - t0 < 5
    finally:
        stall.set()
    # Latest-only mode ends instead.
    stall2 = threading.Event()
    src = _source(NumberedCap(stall=stall2), timeout_s=0.2)
    try:
        assert list(src.frames()) == []
    finally:
        stall2.set()
    for t in grabbers():
        t.join(5)
    assert not grabbers()


def test_closing_early_stops_the_grabber():
    cap = NumberedCap(n_frames=1000)
    src = _source(cap, latest_only=False, queue_frames=4)
    gen = src.frames()
    assert [int(next(gen)[0, 0]) for _ in range(3)] == [1, 2, 3]
    assert len(grabbers()) == 1
    gen.close()
    assert not grabbers() and cap.released
    assert cap.reads <= 3 + 4 + 1


def test_max_frames_and_frame_count_are_kept():
    cap = NumberedCap(n_frames=100)
    src = _source(cap, latest_only=False, max_frames=5, queue_frames=16)
    assert [int(f[0, 0]) for f in src.frames()] == [1, 2, 3, 4, 5]
    assert src.frame_count == 5 and cap.reads == 5


def _small_problem():
    rng = np.random.default_rng(2)
    t = rng.integers(0, 255, (12, 16), np.uint8)
    frames = []
    for k in range(25):
        f = rng.integers(0, 40, (48, 64), np.uint8)
        f[10 + k % 20:22 + k % 20, 20:36] = t
        frames.append(f)
    straggler = rng.integers(0, 40, (40, 56), np.uint8)
    straggler[5:17, 9:25] = t
    cfg = tfipm.MatchConfig(max_pos=1, score=0.5, tolerance_angle=0.0)
    pattern = tfipm.learn_pattern(t, cfg.min_reduce_area, device="cpu")
    return frames[:24] + [straggler], pattern, cfg


def test_inspect_corpus_flushes_a_full_batch_before_the_next_frame(
        monkeypatch):
    frames, pattern, cfg = _small_problem()
    pulled = []

    def stream():
        for f in frames:
            pulled.append(len(pulled))
            yield f

    sizes = []
    real = corpus.match_many_arrays

    def counted(srcs, *a, **k):
        sizes.append(len(srcs))
        return real(srcs, *a, **k)

    monkeypatch.setattr(corpus, "match_many_arrays", counted)
    reports = corpus.inspect_corpus(stream(), pattern, cfg, batch_size=8,
                                    device="cpu")
    first = [next(reports) for _ in range(8)]
    assert len(pulled) == 8 and sizes == [8]
    rest = list(reports)
    assert sizes == [8, 8, 8, 1]
    got = first + rest
    assert [r.index for r in got] == list(range(25))
    want = [tfipm.match(f, pattern, cfg, device="cpu") for f in frames]
    for r, w in zip(got, want):
        assert [(m.score, m.center) for m in r.results] == \
            [(m.score, m.center) for m in w]


def _traced(fn):
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    rows = profiling.spans()
    profiling.reset_spans()
    return out, rows


def test_stream_spans_and_counters_under_the_profiler():
    cap = NumberedCap(n_frames=100, colour=True)
    src = _source(cap, latest_only=False, max_frames=6, queue_frames=8)

    def consume():
        out = []
        for f in src.frames():
            out.append(f)
            time.sleep(0.02)              # the grabber runs ahead
        return out

    me = threading.get_ident()
    frames, rows = _traced(consume)
    assert len(frames) == 6
    by = {}
    for r in rows:
        by.setdefault(r.name, []).append(r)
    grabs = by["fipm.source.grab"]
    assert len(grabs) == 6
    assert all(r.thread != me and r.end_ns is not None for r in grabs)
    for child in ("fipm.source.read", "fipm.source.grey"):
        assert [rows[r.parent].name for r in by[child]] == \
            ["fipm.source.grab"] * 6
    assert [r.thread for r in by["fipm.source.take"]] == [me] * 6
    assert program.counts(rows, "source.frames") == 6
    ready = program.counts(rows, "source.ready")
    assert 1 <= ready <= 6
    assert program.counter_pct({}, "source.ready", "source.frames",
                               rows) == 100.0 * ready / 6
    assert program.span_ms_per_frame({"frames": 6}, "fipm.source.grab",
                                     rows) > 0
    assert profiling._helpers == 0
    # With the profiler off nothing is recorded.
    assert len(list(_source(NumberedCap(n_frames=3),
                            latest_only=False).frames())) == 3
    assert profiling.spans() == []


def test_latest_only_counts_the_frames_it_drops():
    before = profiling.counter("source.dropped")
    src = _source(NumberedCap(n_frames=1000, delay=0.001), max_frames=4)
    got = []
    for f in src.frames():
        got.append(int(f[0, 0]))
        time.sleep(0.05)
    assert len(got) == 4 and src.frame_count == 4   # max_frames
    assert got == sorted(got) and got[-1] - got[0] > 3   # frames skipped
    assert profiling.counter("source.dropped") > before
    assert not grabbers()


def test_one_corpus_batch_span_a_batch():
    frames, pattern, cfg = _small_problem()
    reports, rows = _traced(lambda: list(corpus.inspect_corpus(
        iter(frames[:10]), pattern, cfg, batch_size=4, device="cpu")))
    assert len(reports) == 10
    batches = [r for r in rows if r.name == "fipm.corpus.batch"]
    assert len(batches) == 3 and all(r.parent == -1 for r in batches)
    results = [r for r in rows if r.name == "fipm.results"]
    assert len(results) == 10
    assert all(rows[r.parent].name == "fipm.corpus.batch" for r in results)


def test_reference_loads_neither_the_port_nor_jax():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
            "import fipm_bench.reference.camera; "
            "import fipm_bench.run as run, os; "
            "run.load_module(os.path.join(run.BENCH_DIR, 'scenes', "
            "'camera_parts.py')); "
            "run.load_module(os.path.join(run.BENCH_DIR, 'comparisons', "
            "'match_lists.py')); "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = {m.split(".")[0] for m in json.loads(out.stdout)}
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax",
                       "fastest_image_pattern_matching_tpu",
                       "fastest_image_pattern_matching_tpu_torch"}
