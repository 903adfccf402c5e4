"""Readers of what the port records inside itself: its span table
(fastest_image_pattern_matching_tpu_torch/utils/profiling.py::spans(),
rows of (name, parent index, call id, thread, start ns, end ns, counter
increments)). The port fills the table only while a torch.profiler
session runs, so after a traced run it holds the traced window alone;
an untraced run, or a port without the table, gives no reading (None).
"""

from __future__ import annotations


def table() -> list:
    """The port's span table, or [] where the port keeps none."""
    try:
        from fastest_image_pattern_matching_tpu_torch.utils import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return list(spans()) if callable(spans) else []


def inclusive_ms(rows, name: str) -> float:
    """Milliseconds inside the spans called `name`, each counted once: a
    span under another of the same name is inside that one already."""
    total = 0
    for r in rows:
        if r[0] != name or r[5] is None:
            continue
        p = r[1]
        while 0 <= p < len(rows) and rows[p][0] != name:
            p = rows[p][1]
        if not 0 <= p < len(rows):
            total += r[5] - r[4]
    return total / 1e6


def counts(rows, name: str) -> int:
    """The increments of counter `name` over every span of the table."""
    return sum((r[6] or {}).get(name, 0) for r in rows)


def span_ms_per_frame(rec: dict, name: str, rows=None):
    """Inclusive ms of the spans `name` over the window, per frame."""
    rows = table() if rows is None else rows
    if not rows or not rec.get("frames"):
        return None
    return inclusive_ms(rows, name) / rec["frames"]


def counter_pct(rec: dict, part: str, whole: str, rows=None):
    """100 x the window's increments of counter `part` over those of
    `whole`."""
    rows = table() if rows is None else rows
    den = counts(rows, whole)
    if not rows or den <= 0:
        return None
    return 100.0 * counts(rows, part) / den
