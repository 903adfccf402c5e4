"""The traced window: torch.profiler over the window's calls, reduced in
memory to the records that the per-layer readers take, and the breakdown
of where the device's time went.

The device's busy time is the union of the device intervals of kernels,
copies and fills; its idle share is the rest of the window. Each idle gap
is put down to what the host was doing then: the innermost host event
(an operator, a runtime call, or a range an entry opens, such as
"fipm_bench.decode") that spans the gap's middle, or "python between
operators" where none does.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

WINDOW_SPAN = "fipm_bench.window"
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")
# How many earlier host events to look through for the one spanning a gap.
_LOOKBACK = 256


@contextlib.contextmanager
def profiled():
    """Profile the block on the host and the card; yields a dict that
    holds the profiler's events under "events" once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    box = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield box
            torch.cuda.synchronize()
    # The profiler's raw events: building its FunctionEvent tree
    # (prof.events()) takes a minute for a window of a million events.
    box["events"] = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                      e.end_ns() / 1e3, e.start_thread_id(),
                      e.is_user_annotation())
                     for e in prof.profiler.kineto_results.events()]


def _union_us(spans):
    """The union of intervals: (its length, its disjoint pieces)."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_events(events) -> dict:
    """Records of one traced window from the profiler's events (name,
    device type, start us, end us, thread, user annotation): device
    events (name, start us, end us), device busy seconds, host event
    counts by name, device seconds by name, and the idle gaps with what
    the host was doing in each."""
    from torch.autograd import DeviceType
    device, host = [], []
    window = None
    for name, kind, start, end, thread, annotation in events:
        if kind == DeviceType.CUDA:
            # A host range (the window's own) is mirrored on the device
            # as an annotation; it is no device work.
            if not (annotation or name == WINDOW_SPAN):
                device.append((name, start, end))
        elif kind == DeviceType.CPU:
            if name == WINDOW_SPAN:
                window = (start, end, thread)
            host.append((start, end, name, thread))
    busy_us, merged = _union_us([(a, b) for _, a, b in device])
    by_name = collections.Counter()
    for name, a, b in device:
        by_name[name] += (b - a) / 1e6
    host_counts = collections.Counter(h[2] for h in host)

    gaps = collections.Counter()
    if window is not None:
        main = sorted(h for h in host if h[3] == window[2]
                      and h[2] != WINDOW_SPAN)
        starts = [h[0] for h in main]
        edges = [window[0]] + [x for m in merged for x in m] + [window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2.0
            label = "python between operators"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(-1, j - _LOOKBACK), -1):
                if main[k][1] >= mid:
                    label = main[k][2]
                    break
            gaps[label] += (b - a) / 1e6
    return {"device_events": device, "busy_s": busy_us / 1e6,
            "device_s_by_name": dict(by_name),
            "host_counts": dict(host_counts), "idle_gaps_s": dict(gaps)}


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time and the ten host
    activities under the longest idle time, in seconds."""
    top = sorted(rec["device_s_by_name"].items(), key=lambda kv: -kv[1])
    gaps = sorted(rec["idle_gaps_s"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:160], v] for k, v in top[:10]],
            "idle_gaps": [[k[:160], v] for k, v in gaps[:10]]}
