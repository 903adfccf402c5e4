"""The port's trace context (utils/profiling.py), modelled on
tests/test_profiling.py: device_trace(None) as a no-op, and a CPU trace
written into a directory (the spans and counters are
tests/test_torch_tracing.py's)."""

import json
import os

import torch

from fastest_image_pattern_matching_tpu_torch.utils.profiling import (
    device_trace)

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


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
