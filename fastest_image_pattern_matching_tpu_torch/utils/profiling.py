"""Tracing and profiling helpers — the port of
fastest_image_pattern_matching_tpu/utils/profiling.py.

The reference's only instrumentation is wall-clock around Match()
(MatchToolDlg.cpp:783,1072; chrono in src/TemplateMatcher.cpp:117,402).
Here: stage timers (host wall clock, the device synchronised at the end of
a stage) and a torch.profiler context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


def _sync(x) -> None:
    """Wait for the CUDA device of every tensor in x (a tensor, or a tuple
    or list of them); CPU tensors need no wait."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _sync(v)
    elif x.is_cuda:
        torch.cuda.synchronize(x.device)


class StageTimer:
    """Collects named stage durations (device-synchronised)."""

    def __init__(self):
        self.events: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Times the block. sync: a tensor, or a tuple of them; their CUDA
        device is synchronised (all of its queued work) before the clock
        stops, where the JAX package blocks until `sync` is ready."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.events.append({
                "stage": name,
                "ms": (time.perf_counter() - t0) * 1000.0,
                "t": time.time(),
            })

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e["stage"]] = out.get(e["stage"], 0.0) + e["ms"]
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.events, f, indent=1)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """torch.profiler over the block (CPU and, when there is a card, CUDA
    activity), written as a Chrome trace `trace.json` into trace_dir;
    a no-op when trace_dir is None. Yields the profiler (or None)."""
    if trace_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
