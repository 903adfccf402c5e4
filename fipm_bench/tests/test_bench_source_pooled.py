"""source_pooled_pct.png8 on a synthetic span table: the consumer's
fipm.source.take rows count source.frames, the pool's decode rows (on
other threads) count source.pooled; a port without the counters gives no
reading."""

import json
import os

import pytest

from fipm_bench import program, run

MS = 1_000_000  # ns


def row(name, thread, start_ms, end_ms, counts=None):
    return (name, -1, 0, thread, start_ms * MS, end_ms * MS, counts or {})


def table(pooled, frames):
    rows = [row("fipm.source.decode", 2 + k % 2, k, k + 3,
                {"source.pooled": 1}) for k in range(pooled)]
    rows += [row("fipm.source.take", 1, k, k + 1, {"source.frames": 1})
             for k in range(frames)]
    return rows


def metric():
    return run.load_module(os.path.join(run.BENCH_DIR, "metrics",
                                        "source_pooled_pct.png8.py"))


@pytest.mark.parametrize("pooled, frames, want", [
    (8, 8, 100.0),     # every frame of the folder through the pool
    (0, 8, 0.0),       # an all-BMP folder: the native loader
    (4, 8, 50.0),
])
def test_reads_pooled_over_frames(monkeypatch, pooled, frames, want):
    monkeypatch.setattr(program, "table", lambda: table(pooled, frames))
    assert metric().read({"frames": frames}) == pytest.approx(want)


@pytest.mark.parametrize("rows", [
    [],                                                      # untraced
    [row("fipm.decode.inflate", 1, 0, 3),
     row("fipm.decode.unfilter", 1, 3, 5)],                  # no counters
])
def test_no_reading_without_the_counters(monkeypatch, rows):
    monkeypatch.setattr(program, "table", lambda: list(rows))
    assert metric().read({"frames": 8}) is None


def test_the_manifest_lists_it_for_png8():
    with open(os.path.join(os.path.dirname(run.BENCH_DIR),
                           "BENCHMARK.json")) as f:
        man = json.load(f)
    entry = [m for m in man["per_layer"]
             if m["name"] == "source_pooled_pct.png8"]
    assert entry == [{"name": "source_pooled_pct.png8", "unit": "%",
                      "better": "higher", "source": "program_counter",
                      "layer": "frame input", "moves": "frames_per_s",
                      "workloads": ["flagship.png8"]}]
