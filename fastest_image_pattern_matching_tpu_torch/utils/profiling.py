"""Tracing and profiling: the port's spans, counters and trace exporter.

The reference's only instrumentation is wall-clock around Match()
(MatchToolDlg.cpp:783,1072; chrono in src/TemplateMatcher.cpp:117,402).
Here:

  * span(name): a named range around a layer's or a stage's code. With
    the profiler off it costs one flag check and does nothing else. Under
    any torch.profiler session (device_trace below, or the caller's own)
    it opens record_function(name), so the range appears in the
    profiler's trace, and appends one row to an in-memory table (spans()).
    The table's times are time.time_ns(), the clock the profiler stamps
    its host events with, so the table can be laid over the device trace.
    The profiler covers only the threads it was started on; a helper
    thread working for one of them records rows (and no range) inside
    traced_for(True).
  * count(name, n): a process-wide counter (counter(name)); while a span
    is recording, the increment is also kept on the innermost open span.
  * device_trace(dir): torch.profiler over a block, written as a Chrome
    trace.

Spans launch no device work and read nothing back from the device.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# Rows the span table holds; spans beyond it are counted, not kept.
TABLE_LIMIT = 1 << 20

SpanRecord = collections.namedtuple(
    "SpanRecord", "name parent call thread start_ns end_ns counts")
SpanRecord.__doc__ = """One span: its name; the table index of the
innermost span open on the same thread when it began (-1: none, or one
beyond the table's limit); the id shared by every span of one entry call;
the thread; start and end in ns on time.time_ns()'s clock (end None while
open); the counter increments made while it was the innermost open span."""

_profiler_enabled = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_calls = itertools.count()
_rows: List[list] = []
_dropped = 0
_totals: Dict[str, int] = {}
# Threads inside traced_for(True); while none is, the off path checks
# nothing else.
_helpers = 0


class _Off:
    """The shared span of a run without the profiler: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_rf", "_row")

    def __init__(self, name: str, ranged: bool = True):
        self.name = name
        self._rf = (torch.autograd.profiler.record_function(name)
                    if ranged else None)

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, call = stack[-1][:2] if stack else (-1, next(_calls))
        row = [self.name, parent, call, threading.get_ident(),
               time.time_ns(), None, None]
        global _dropped
        with _lock:
            if len(_rows) < TABLE_LIMIT:
                idx = len(_rows)
                _rows.append(row)
            else:
                idx, row = -1, None
                _dropped += 1
        self._row = row
        stack.append((idx, call, row))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        if self._row is not None:
            self._row[5] = end
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's or stage's code: a no-op with
    the profiler off; under a torch.profiler session a record_function
    range of `name` and a row of the span table; inside traced_for(True)
    a row alone."""
    if _profiler_enabled():
        return _Span(name)
    if _helpers and getattr(_local, "helping", False):
        return _Span(name, ranged=False)
    return _OFF


def tracing() -> bool:
    """Whether spans on this thread record: the profiler covers it, or
    it is inside traced_for(True)."""
    return _profiler_enabled() or bool(
        _helpers and getattr(_local, "helping", False))


@contextlib.contextmanager
def traced_for(on: bool):
    """Run the block as a helper of a thread whose tracing() was `on`:
    when on, spans of the block on this thread keep rows in the table
    (under their own thread id and call ids) without opening a
    record_function range, which the profiler would not see from here."""
    global _helpers
    if not on:
        yield
        return
    with _lock:
        _helpers += 1
    _local.helping = True
    try:
        yield
    finally:
        _local.helping = False
        with _lock:
            _helpers -= 1


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide counter `name`, and to the innermost open
    span's counts when a span is recording on this thread."""
    row = None
    if _profiler_enabled() or _helpers:
        stack = getattr(_local, "stack", None)
        row = stack[-1][2] if stack else None
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
        if row is not None:
            counts = row[6] = row[6] or {}
            counts[name] = counts.get(name, 0) + n


def counter(name: str) -> int:
    """The process-wide total of counter `name` (0 before its first
    count)."""
    return _totals.get(name, 0)


def spans() -> List[SpanRecord]:
    """The span table, in the order the spans began; a row's `parent` is
    an index into this list."""
    with _lock:
        return [SpanRecord(r[0], r[1], r[2], r[3], r[4], r[5],
                           dict(r[6] or ())) for r in _rows]


def dropped_spans() -> int:
    """Spans not kept since the last reset_spans(): the table was full."""
    return _dropped


def reset_spans() -> None:
    """Empty the span table (between calls: a span still open then keeps
    no row)."""
    global _dropped
    with _lock:
        _rows.clear()
        _dropped = 0


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """torch.profiler over the block (CPU and, when there is a card, CUDA
    activity), written as a Chrome trace `trace.json` into trace_dir;
    a no-op when trace_dir is None. Yields the profiler (or None). The
    port's spans appear in the trace and in spans()."""
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
