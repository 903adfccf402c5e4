"""The readers of the port's span table (program.py) and the ten metrics
that use them, on a synthetic table: inclusive ms a frame, the live
share, and no reading where the table is empty."""

import glob
import os

import pytest

from fipm_bench import program, run

MS = 1_000_000  # ns


def row(name, parent, start_ms, end_ms, counts=None):
    return (name, parent, 0, 1, start_ms * MS,
            None if end_ms is None else end_ms * MS, counts or {})


# Two frames' calls: a sweep of 4 ms (peaks 1 + 1 ms inside it), a descent
# of 6 ms with two levels, decode pieces; a nested fipm.descent (the
# two-phase compaction is another, sibling, one) counts once.
TABLE = [
    row("fipm.match", -1, 0, 20),                                   # 0
    row("fipm.prepare", 0, 0, 2),                                   # 1
    row("fipm.sweep", 0, 2, 6),                                     # 2
    row("fipm.sweep.chunk", 2, 2, 6),                               # 3
    row("fipm.peaks", 3, 3, 4),                                     # 4
    row("fipm.peaks", 3, 5, 6),                                     # 5
    row("fipm.descent", 0, 6, 12),                                  # 6
    row("fipm.descent.L1", 6, 6, 9, {"descent.slots": 8,
                                     "descent.live": 6}),           # 7
    row("fipm.descent", 7, 7, 8),                                   # 8
    row("fipm.descent.L0", 6, 9, 12, {"descent.slots": 8,
                                      "descent.live": 2}),          # 9
    row("fipm.finalize", 0, 12, 15),                                # 10
    row("fipm.descent", 0, 15, 16),                                 # 11
    row("fipm.decode.inflate", -1, 20, 23),                         # 12
    row("fipm.decode.unfilter", -1, 23, 30),                        # 13
    row("fipm.decode.unfilter", -1, 30, None),                      # 14
]


@pytest.fixture
def table(monkeypatch):
    monkeypatch.setattr(program, "table", lambda: list(TABLE))


def metric(name):
    return run.load_module(os.path.join(run.BENCH_DIR, "metrics",
                                        name + ".py"))


def test_inclusive_ms_counts_each_span_once():
    assert program.inclusive_ms(TABLE, "fipm.descent") == 7.0
    assert program.inclusive_ms(TABLE, "fipm.peaks") == 2.0
    assert program.inclusive_ms(TABLE, "fipm.decode.unfilter") == 7.0
    assert program.inclusive_ms(TABLE, "fipm.absent") == 0.0
    assert program.counts(TABLE, "descent.live") == 8


@pytest.mark.parametrize("name, want", [
    ("prepare_ms_per_frame.one", 1.0), ("sweep_ms_per_frame.one", 2.0),
    ("peaks_ms_per_frame.one", 1.0), ("descent_ms_per_frame.one", 3.5),
    ("finalize_ms_per_frame.one", 1.5), ("sweep_ms_per_frame.batch", 2.0),
    ("descent_ms_per_frame.batch", 3.5),
    ("inflate_ms_per_frame.png8", 1.5), ("unfilter_ms_per_frame.png8", 3.5),
    ("descent_live_pct.one", 50.0),
])
def test_each_metric_reads_the_table(table, name, want):
    assert metric(name).read({"frames": 2}) == pytest.approx(want)


def test_the_ten_metrics_are_the_manifests():
    import json
    with open(os.path.join(os.path.dirname(run.BENCH_DIR),
                           "BENCHMARK.json")) as f:
        man = json.load(f)
    spans = {m["name"] for m in man["per_layer"]
             if m["source"] in ("program_span", "program_counter")}
    assert len(spans) == 10
    files = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(run.BENCH_DIR, "metrics", "*.py"))}
    assert spans <= files


@pytest.mark.parametrize("name", ["sweep_ms_per_frame.one",
                                  "descent_live_pct.one",
                                  "inflate_ms_per_frame.png8"])
def test_no_reading_without_a_table(monkeypatch, name):
    monkeypatch.setattr(program, "table", lambda: [])
    assert metric(name).read({"frames": 2}) is None


def test_no_reading_without_frames_or_slots(table):
    assert metric("sweep_ms_per_frame.one").read({"frames": 0}) is None
    assert program.counter_pct({}, "descent.live", "no.slots") is None


def test_a_port_without_the_table_gives_none(monkeypatch):
    """The parent of the change that brought the table: a profiling
    module without spans() reads as an empty table, and nothing raises."""
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert program.table() == []
    assert metric("descent_ms_per_frame.one").read({"frames": 3}) is None


def test_the_port_table_is_read_after_a_traced_window(tiny_root,
                                                      monkeypatch):
    """A traced tiny run on the CPU reads every span metric of its cell
    from the port's own table."""
    import torch
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    cell = run.find_cell(str(tiny_root), "tiny.one",
                         str(tiny_root / "fipm_bench"))
    profiling.reset_spans()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    result, _ = run.run_cell(cell, 2**31 + 3, 0.3, True, "cpu")
    got = result["metrics"]
    for name in ("prepare_ms_per_frame.one", "sweep_ms_per_frame.one",
                 "peaks_ms_per_frame.one", "descent_ms_per_frame.one",
                 "finalize_ms_per_frame.one"):
        assert got[name]["value"] > 0, name
    assert 0 < got["descent_live_pct.one"]["value"] <= 100
