"""The port's spans and counters (utils/profiling.py) on the CPU: nothing
recorded with the profiler off; under torch.profiler every span of match
and match_many, nested as the stages nest, one call id a call, on the
profiler's clock, with the results unchanged; the descent's live and slot
counters; the PNG decode's split; chunked_map's chunks; the spans and
counters of orb_match and orb_match_many, results bit-equal with the
profiler on and off; the spans and counters of a glyph read
(MultiTemplateMatcher.match_all through match_patterns, the suppression
across glyphs, read_string)."""

import threading

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.utils import chunking
from fastest_image_pattern_matching_tpu_torch.utils import profiling
from fastest_image_pattern_matching_tpu_torch.utils.codecs import png
from fastest_image_pattern_matching_tpu_torch.utils.imageio import load_gray
from fipm_bench import program
from tests.test_torch_match import _paste_rotated

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

# Each span of a match and the spans it may open inside ("L" stands for
# every fipm.descent.L<l>).
PARENT = {
    "fipm.prepare": ("fipm.match",), "fipm.upload": ("fipm.prepare",),
    "fipm.pyramid": ("fipm.match",), "fipm.sweep": ("fipm.match",),
    "fipm.sweep.chunk": ("fipm.sweep",),
    "fipm.ncc": ("fipm.sweep.chunk", "fipm.descent.chunk"),
    "fipm.ncc.corr": ("fipm.ncc",), "fipm.ncc.sums": ("fipm.ncc",),
    "fipm.ncc.score": ("fipm.ncc",),
    "fipm.peaks": ("fipm.sweep.chunk",), "fipm.peaks.round": ("fipm.peaks",),
    "fipm.select": ("fipm.match",), "fipm.descent": ("fipm.match",),
    "L": ("fipm.descent",), "fipm.descent.chunk": ("L",),
    "fipm.descent.maps": ("fipm.descent.chunk",),
    "fipm.descent.warp": ("fipm.descent.chunk",),
    "fipm.descent.best": ("fipm.descent.chunk",),
    "fipm.join": ("L",), "fipm.descent.pick": ("L",),
    "fipm.descent.subpixel": ("fipm.descent.pick",),
    "fipm.finalize": ("fipm.match",),
    "fipm.nms": ("fipm.finalize",), "fipm.nms.area": ("fipm.nms",),
    "fipm.nms.clip": ("fipm.nms.area",), "fipm.nms.greedy": ("fipm.nms",),
    "fipm.finalize.pick": ("fipm.finalize",),
    "fipm.readback": ("fipm.match",), "fipm.results": ("fipm.match",),
}


def _kind(name):
    return "L" if name.startswith("fipm.descent.L") else name


@pytest.fixture(scope="module")
def problem():
    """Two 200x240 frames with a 40x56 part at 20 and -15 deg; the plan's
    top layer (2) is above its stop layer (0), so the candidates
    descend."""
    t = np.full((40, 56), 30, np.uint8)
    cv2.rectangle(t, (4, 4), (51, 35), 200, 2)
    cv2.line(t, (8, 8), (48, 30), 255, 3)
    frames = []
    for k, a in enumerate((20.0, -15.0)):
        f = np.random.default_rng(20 + k).integers(0, 30, (200, 240),
                                                   np.uint8)
        _paste_rotated(f, t, 96.0, 80.0, a)
        frames.append(f)
    cfg = tfipm.MatchConfig(max_pos=2, score=0.6, tolerance_angle=30.0,
                            max_overlap=0.3)
    pattern = tfipm.learn_pattern(t, cfg.min_reduce_area, device="cpu")
    assert pattern.top_layer > 0
    return np.stack(frames), pattern, cfg


def _traced(fn):
    """fn() under the CPU profiler: (its value, the span table, the
    profiler's fipm.* ranges as (name, start ns, end ns) in start order)."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    rows = profiling.spans()
    profiling.reset_spans()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("fipm."))
    return out, rows, [(n, a, b) for a, b, n in ranges]


def _rows_of(results):
    return [(r.score, r.angle, r.center, r.lt, r.rt, r.rb, r.lb)
            for r in results]


def _check_tree(rows, entry, results=True):
    """Every span of PARENT under `entry` (fipm.results only where the
    entry builds MatchResults), nested as PARENT says, one call id."""
    names = {r.name for r in rows}
    want = set(PARENT) - {"L", "fipm.match"} | {entry}
    if not results:
        want.discard("fipm.results")
    assert want <= names, want - names
    assert any(n.startswith("fipm.descent.L") for n in names)
    assert len({r.call for r in rows}) == 1
    assert len({r.thread for r in rows}) == 1
    for r in rows:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        if r.name == entry:
            assert r.parent == -1
            continue
        p = rows[r.parent]
        parents = {entry if n == "fipm.match" else n
                   for n in PARENT[_kind(r.name)]}
        assert _kind(p.name) in parents, (r.name, p.name)
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_span_is_a_shared_noop_with_the_profiler_off():
    profiling.reset_spans()
    assert profiling.span("fipm.a") is profiling.span("fipm.b")
    with profiling.span("fipm.a"):
        profiling.count("test.off", 2)
    assert profiling.spans() == []
    assert profiling.counter("test.off") >= 2


def test_profiler_off_records_nothing(problem):
    frames, pattern, cfg = problem
    profiling.reset_spans()
    slots = profiling.counter("descent.slots")
    tfipm.match(frames[0], pattern, cfg, device="cpu")
    tfipm.match_many(frames, pattern, cfg, device="cpu")
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    assert profiling.counter("descent.slots") > slots


def test_match_spans_nest_share_a_call_and_leave_results(problem):
    frames, pattern, cfg = problem
    plain = tfipm.match(frames[0], pattern, cfg, device="cpu")
    traced, rows, _ = _traced(
        lambda: tfipm.match(frames[0], pattern, cfg, device="cpu"))
    assert _rows_of(traced) == _rows_of(plain) and len(plain) >= 1
    _check_tree(rows, "fipm.match")
    assert [r.name for r in rows].count("fipm.match") == 1


def test_match_many_spans_nest_share_a_call_and_leave_results(problem):
    frames, pattern, cfg = problem
    plain = tfipm.match_many_arrays(frames, pattern, cfg, device="cpu")
    traced, rows, _ = _traced(
        lambda: tfipm.match_many_arrays(frames, pattern, cfg, device="cpu"))
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k])
    _check_tree(rows, "fipm.match_many", results=False)
    many, rows, _ = _traced(
        lambda: tfipm.match_many(frames, pattern, cfg, device="cpu"))
    _check_tree(rows, "fipm.match_many")
    assert [_rows_of(m) for m in many] == [
        _rows_of(tfipm.match(f, pattern, cfg, device="cpu"))
        for f in frames]


def test_each_call_has_its_own_call_id(problem):
    frames, pattern, cfg = problem

    def twice():
        tfipm.match(frames[0], pattern, cfg, device="cpu")
        tfipm.match(frames[1], pattern, cfg, device="cpu")
    _, rows, _ = _traced(twice)
    entries = [i for i, r in enumerate(rows) if r.name == "fipm.match"]
    assert len(entries) == 2
    first = {r.call for r in rows[:entries[1]]}
    second = {r.call for r in rows[entries[1]:]}
    assert len(first) == len(second) == 1 and first != second


def test_table_lies_on_the_profilers_clock(problem):
    frames, pattern, cfg = problem
    _, rows, ranges = _traced(
        lambda: tfipm.match(frames[0], pattern, cfg, device="cpu"))
    assert [r.name for r in rows] == [n for n, _, _ in ranges]
    for r, (_, a, b) in zip(rows, ranges):
        assert abs(r.start_ns - a) < 5e6 and abs(r.end_ns - b) < 5e6


def test_descent_counts_live_and_slots(problem):
    frames, pattern, cfg = problem
    results, rows, _ = _traced(
        lambda: tfipm.match(frames[0], pattern, cfg, device="cpu"))
    counts = [r.counts for r in rows if r.counts]
    assert counts and all(_kind(r.name) == "L" for r in rows if r.counts)
    live = sum(c.get("descent.live", 0) for c in counts)
    slots = sum(c.get("descent.slots", 0) for c in counts)
    levels = sum(1 for r in rows if _kind(r.name) == "L")
    assert len(counts) == levels
    assert len(results) <= live <= slots


def test_png_decode_splits_into_four_children(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (37, 53), np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(png.encode_gray8(img))
    got, rows, _ = _traced(lambda: load_gray(path))
    np.testing.assert_array_equal(got, img)
    assert [r.name for r in rows] == [
        "fipm.decode", "fipm.decode.read", "fipm.decode.inflate",
        "fipm.decode.unfilter", "fipm.decode.grey"]
    assert all(r.parent == 0 for r in rows[1:])
    assert all(a.end_ns <= b.start_ns for a, b in zip(rows[1:], rows[2:]))


@pytest.mark.parametrize("alive", [
    [0, 0, 1, 0, 0, 0, 0, 0, 1, 1, 0],   # interior dead chunks
    [1] * 11,                            # every chunk runs
    [0] * 11,                            # none alive: the first runs
])
def test_chunked_map_runs_the_same_chunks(alive):
    """The chunks that run are those holding a True entry (the first one
    when none does), as before the counters; slots and live count them."""
    n, chunk = len(alive), 3
    pred = torch.tensor(alive, dtype=torch.bool)
    ran = []

    def fn(args):
        ran.append(int(args[0][0]))
        return (args[0] * 2,)
    x = torch.arange(n)
    s0, l0 = (profiling.counter("t.slots"), profiling.counter("t.live"))
    out = chunking.chunked_map(fn, (x,), n, chunk, pred=pred,
                               count_as="t")[0]
    bounds = [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]
    want = [lo for lo, hi in bounds if any(alive[lo:hi])] or [0]
    assert ran == want
    for lo, hi in bounds:
        expect = (x[lo:hi] * 2 if any(alive[lo:hi]) or all(alive)
                  else torch.zeros(hi - lo, dtype=x.dtype))
        assert torch.equal(out[lo:hi], expect)
    assert profiling.counter("t.slots") - s0 == sum(
        min(n, lo + chunk) - lo for lo in want)
    assert profiling.counter("t.live") - l0 == sum(alive)


def test_counts_go_to_the_innermost_span_and_the_total():
    def body():
        with profiling.span("fipm.outer"):
            profiling.count("t.c")
            with profiling.span("fipm.inner"):
                profiling.count("t.c", 5)
    before = profiling.counter("t.c")
    _, rows, _ = _traced(body)
    assert [(r.name, r.counts) for r in rows] == [
        ("fipm.outer", {"t.c": 1}), ("fipm.inner", {"t.c": 5})]
    assert profiling.counter("t.c") == before + 6


def test_a_failing_span_closes_and_the_stack_unwinds():
    def body():
        with pytest.raises(ValueError):
            with profiling.span("fipm.bad"):
                raise ValueError("x")
        with profiling.span("fipm.next"):
            pass
    _, rows, _ = _traced(body)
    assert [(r.name, r.parent) for r in rows] == [("fipm.bad", -1),
                                                 ("fipm.next", -1)]
    assert rows[0].end_ns is not None and rows[0].call != rows[1].call


def test_a_thread_outside_the_profiler_records_nothing():
    """torch.profiler is on for the threads it covers (this one); a span
    on another thread is the no-op one, and this thread's stack is
    untouched by it."""
    seen = []

    def worker():
        seen.append(profiling.span("fipm.worker"))
        with seen[0]:
            pass

    def body():
        with profiling.span("fipm.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.span("fipm.after"):
                pass
    _, rows, _ = _traced(body)
    assert seen == [profiling.span("fipm.off")]
    assert [(r.name, r.parent) for r in rows] == [("fipm.main", -1),
                                                 ("fipm.after", 0)]


def test_pool_decode_spans_record_for_a_traced_consumer(tmp_path):
    """FileSource's pool decodes on its own threads. Under the profiler on
    the consuming thread their decode spans are rows of the table under
    the workers' thread ids, with no profiler range; the benchmark's
    readers find inflate and unfilter time in them. The consumer's waits
    are fipm.source.take ranges, counting source.frames; the workers count
    source.pooled. With the profiler off nothing is recorded."""
    from fastest_image_pattern_matching_tpu_torch.utils import sources
    from fipm_bench import program
    rng = np.random.default_rng(5)
    for i in range(6):
        (tmp_path / f"f{i}.png").write_bytes(
            png.encode_gray8(rng.integers(0, 256, (64, 80), np.uint8)))
    src = sources.FolderSource(str(tmp_path), n_threads=3)
    me = threading.get_ident()
    frames, rows, ranges = _traced(lambda: list(src))
    assert len(frames) == 6
    by = {}
    for r in rows:
        by.setdefault(r.name, []).append(r)
    for name in ("fipm.source.decode", "fipm.decode", "fipm.decode.read",
                 "fipm.decode.inflate", "fipm.decode.unfilter",
                 "fipm.decode.grey"):
        assert len(by[name]) == 6, name
        assert all(r.thread != me and r.end_ns is not None
                   for r in by[name]), name
    assert [r.thread for r in by["fipm.source.take"]] == [me] * 6
    assert {n for n, _, _ in ranges} == {"fipm.source.take"}
    assert program.counts(rows, "source.frames") == 6
    assert program.counts(rows, "source.pooled") == 6
    assert program.counter_pct({}, "source.pooled", "source.frames",
                               rows) == 100.0
    for name in ("fipm.decode.inflate", "fipm.decode.unfilter"):
        assert program.span_ms_per_frame({"frames": 6}, name, rows) > 0
    profiling.reset_spans()
    assert len(list(src)) == 6
    assert profiling.spans() == [] and profiling._helpers == 0


def test_the_table_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "TABLE_LIMIT", 2)

    def body():
        for _ in range(2):
            with profiling.span("fipm.kept"):
                pass
        with profiling.span("fipm.dropped"):
            with profiling.span("fipm.child"):
                pass
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        body()
    assert [r.name for r in profiling.spans()] == ["fipm.kept"] * 2
    assert profiling.dropped_spans() == 2
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


# Each span of an ORB call and the span it opens inside.
ORB_PARENT = {
    "fipm.orb.upload": "fipm.orb", "fipm.upload": "fipm.orb.upload",
    "fipm.orb.detect": "fipm.orb", "fipm.orb.level": "fipm.orb.detect",
    "fipm.orb.resize": "fipm.orb.level", "fipm.orb.fast": "fipm.orb.level",
    "fipm.orb.harris": "fipm.orb.level", "fipm.orb.select": "fipm.orb.level",
    "fipm.orb.orient": "fipm.orb.level",
    "fipm.orb.describe": "fipm.orb.level",
    "fipm.orb.match": "fipm.orb", "fipm.orb.ransac": "fipm.orb",
    "fipm.orb.ransac.hyp": "fipm.orb.ransac",
    "fipm.orb.ransac.lo": "fipm.orb.ransac",
    "fipm.orb.readback": "fipm.orb", "fipm.orb.results": "fipm.orb",
}


@pytest.fixture(scope="module")
def orb_problem():
    """Two 240x320 frames of the benchmark's textured-part scene, each
    holding a 96x128 part, and the default ORBConfig."""
    from fipm_bench.scenes import textured_part
    params = {"frame_hw": [240, 320], "noise": 40,
              "template": {"hw": [96, 128], "block": 8, "blur": 1.0,
                           "disc_area": 1500, "disc_r": [3, 9]},
              "poses": [[160.0, 120.0, -23.0], [150.0, 115.0, 12.0]]}
    templ, frames, _ = textured_part.make_pool(
        params, 2, 0, np.random.default_rng(3))
    return frames, templ, tfipm.ORBConfig()


def _orb_fields(r):
    return (r.is_matched, r.num_inliers, r.num_good_matches,
            r.avg_pixel_shift, r.homography.tobytes(), r.corners.tobytes(),
            r.src_pts.tobytes(), r.dst_pts.tobytes(),
            r.inlier_mask.tobytes(), r.rotation_angle)


def _check_orb_tree(rows, cfg, sources):
    from fastest_image_pattern_matching_tpu_torch.models import orb
    names = [r.name for r in rows]
    assert names[0] == "fipm.orb" and names.count("fipm.orb") == 1
    assert rows[0].parent == -1
    assert set(ORB_PARENT) <= set(names), set(ORB_PARENT) - set(names)
    assert len({r.call for r in rows}) == 1
    for r in rows[1:]:
        p = rows[r.parent]
        assert p.name == ORB_PARENT[r.name], (r.name, p.name)
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    levels = sum(b > 0 for b in orb._level_budgets(cfg))
    assert names.count("fipm.orb.detect") == 2
    assert names.count("fipm.orb.level") == 2 * levels
    for leaf in ("fast", "harris", "select", "orient", "describe"):
        assert names.count("fipm.orb." + leaf) == 2 * levels
    assert names.count("fipm.orb.resize") == 2 * (levels - 1)
    for name in ("fipm.orb.match", "fipm.orb.ransac", "fipm.orb.ransac.hyp",
                 "fipm.orb.ransac.lo", "fipm.orb.readback"):
        assert names.count(name) == 1, name
    # orb.levels counts each level once per image: the template and the
    # sources.
    assert program.counts(rows, "orb.levels") == levels * (1 + sources)
    assert program.counts(rows, "orb.hypotheses") == \
        cfg.ransac_iters * sources
    assert program.counts(rows, "orb.frames") == sources


def test_orb_profiler_off_records_nothing(orb_problem):
    frames, templ, cfg = orb_problem
    profiling.reset_spans()
    frames_before = profiling.counter("orb.frames")
    tfipm.orb_match(frames[0], templ, cfg, device="cpu")
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    assert profiling.counter("orb.frames") == frames_before + 1


def test_orb_match_spans_nest_count_and_leave_results(orb_problem):
    frames, templ, cfg = orb_problem
    plain = tfipm.orb_match(frames[0], templ, cfg, device="cpu")
    traced, rows, ranges = _traced(
        lambda: tfipm.orb_match(frames[0], templ, cfg, device="cpu"))
    assert plain.is_matched
    assert _orb_fields(traced) == _orb_fields(plain)
    _check_orb_tree(rows, cfg, 1)
    assert [r.name for r in rows] == [n for n, _, _ in ranges]
    assert program.counts(rows, "orb.inliers") == traced.num_inliers
    assert program.counts(rows, "orb.good") == traced.num_good_matches
    ransac = [r for r in rows if r.name == "fipm.orb.ransac"][0]
    assert ransac.counts == {"orb.hypotheses": cfg.ransac_iters}


def test_orb_match_many_spans_count_every_frame(orb_problem):
    frames, templ, cfg = orb_problem
    plain = tfipm.orb_match_many(frames, templ, cfg, device="cpu")
    traced, rows, _ = _traced(
        lambda: tfipm.orb_match_many(frames, templ, cfg, device="cpu"))
    assert [_orb_fields(r) for r in traced] == \
        [_orb_fields(r) for r in plain]
    _check_orb_tree(rows, cfg, len(frames))
    assert program.counts(rows, "orb.inliers") == sum(
        r.num_inliers for r in traced)


# Each span of a glyph read and the span it opens inside (fipm.ocr and
# fipm.ocr.read are entries of their own).
OCR_PARENT = {
    "fipm.match_patterns": "fipm.ocr", "fipm.ocr.cross_nms": "fipm.ocr",
    "fipm.patterns.pattern": "fipm.match_patterns",
}
# The stages of one pattern.
PATTERN_STAGES = {"fipm.sweep", "fipm.select", "fipm.descent",
                  "fipm.finalize"}


@pytest.fixture(scope="module")
def ocr_problem():
    """Six glyphs of one shape (look-alikes among them) learned by a
    MultiTemplateMatcher at the CLI's ocr settings, and a 120x320 plate
    that stamps four of them."""
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import MultiTemplateMatcher
    from fipm_bench.scenes import glyph_plate
    plate, _ = glyph_plate.ocr_plate("0B1O", hw=(120, 320), y0=34)
    cfg = tfipm.MatchConfig(max_pos=8, score=0.85, tolerance_angle=0.0,
                            max_overlap=0.4, min_reduce_area=256)
    m = MultiTemplateMatcher(cfg, device="cpu")
    for ch in "0O8B1I":
        m.learn(ch, glyph_plate.glyph(ch))
    return plate, m


def _labelled(matches):
    return [(m.label,) + _rows_of([m.result])[0] for m in matches]


def test_ocr_profiler_off_records_nothing(ocr_problem):
    plate, m = ocr_problem
    profiling.reset_spans()
    runs = profiling.counter("patterns.run")
    m.match_all(plate, cross_nms=True)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    assert profiling.counter("patterns.run") == runs + len(m.patterns)


def test_ocr_spans_nest_count_and_leave_results(ocr_problem):
    from fastest_image_pattern_matching_tpu_torch.models.multi_template \
        import read_string
    plate, m = ocr_problem
    plain = m.match_all(plate, cross_nms=True)
    unsuppressed = m.match_all(plate)

    def read():
        out = m.match_all(plate, cross_nms=True)
        return out, read_string(out, m.config.score)
    (traced, text), rows, ranges = _traced(read)
    assert _labelled(traced) == _labelled(plain) and text == "0B1O"
    assert [r.name for r in rows] == [n for n, _, _ in ranges]
    names = [r.name for r in rows]
    assert [n for n, r in zip(names, rows) if r.parent == -1] == [
        "fipm.ocr", "fipm.ocr.read"]
    assert len({r.call for r in rows}) == 2
    for r in rows:
        if r.parent == -1:
            continue
        p = rows[r.parent]
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        if r.name in OCR_PARENT:
            assert p.name == OCR_PARENT[r.name], (r.name, p.name)
        if p.name == "fipm.patterns.pattern":
            assert r.name in PATTERN_STAGES, r.name
    n = len(m.patterns)
    assert names.count("fipm.match_patterns") == 1
    assert names.count("fipm.ocr.cross_nms") == 1
    # The group's stacked candidates, then its finalize.
    assert names.count("fipm.patterns.pattern") == 2
    assert program.counts(rows, "patterns.run") == n
    assert program.counts(rows, "patterns.stacked") == n
    assert program.counts(rows, "patterns.groups") == 1
    matches = program.counts(rows, "ocr.matches")
    kept = program.counts(rows, "ocr.kept")
    assert (matches, kept) == (len(unsuppressed), len(traced))
    assert kept < matches
    assert program.inclusive_ms(rows, "fipm.patterns.pattern") > 0.0
