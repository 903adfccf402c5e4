"""The port's stage timers and trace context (utils/profiling.py), modelled
on tests/test_profiling.py: the stage summary, dump, device_trace(None) as
a no-op, and a CPU trace written into a directory."""

import json
import os

import pytest
import torch

from fastest_image_pattern_matching_tpu_torch.utils.profiling import (
    StageTimer, device_trace)

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def test_stage_timer(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    x = torch.ones((8, 8)).sum()
    with t.stage("b", sync=x):
        pass
    with t.stage("b", sync=(x, x * 2)):
        pass
    s = t.summary()
    assert set(s) == {"a", "b"}
    assert all(v >= 0 for v in s.values())
    assert [e["stage"] for e in t.events] == ["a", "b", "b"]
    assert s["b"] == pytest.approx(t.events[1]["ms"] + t.events[2]["ms"])
    t.dump(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert [e["stage"] for e in json.load(f)] == ["a", "b", "b"]


def test_stage_timer_records_a_failing_stage():
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("bad"):
            raise ValueError("x")
    assert list(t.summary()) == ["bad"]


def test_device_trace_noop():
    with device_trace(None) as prof:
        assert prof is None


def test_device_trace_writes_a_chrome_trace(tmp_path):
    out = str(tmp_path / "trace")
    with device_trace(out) as prof:
        assert prof is not None
        torch.nn.functional.conv2d(torch.ones(1, 1, 16, 16),
                                   torch.ones(1, 1, 3, 3))
    path = os.path.join(out, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
