"""What the metric readers under metrics/ share. A reader takes the
records of one run and returns its metric, or None where the run has
nothing to read it from (the harness then leaves the metric out).

Records of an untraced run: "latencies_s" (every call of the window),
"frames", "window_s", "setup_s". Records of a traced run: "frames",
"window_s", "spans" ((name, start s, end s) from the entries), "work"
(the least seconds of the reference's kernel work for the window's
answers, by kind) and what trace.reduce_events gives: "device_events",
"busy_s", "device_s_by_name", "host_counts", "idle_gaps_s".
"""

from __future__ import annotations

import numpy as np

from .trace import HOST_SYNCS


def latency_quantile_ms(rec: dict, q: float):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(lat, q)) * 1e3


def frames_per_s(rec: dict):
    if not rec.get("frames") or not rec.get("window_s"):
        return None
    return rec["frames"] / rec["window_s"]


def device_idle_pct(rec: dict):
    if "busy_s" not in rec or not rec["device_events"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def device_ops_per_frame(rec: dict):
    if "device_events" not in rec or not rec["frames"]:
        return None
    return len(rec["device_events"]) / rec["frames"]


def host_syncs_per_frame(rec: dict):
    if "host_counts" not in rec or not rec["frames"]:
        return None
    return sum(rec["host_counts"].get(k, 0) for k in HOST_SYNCS) \
        / rec["frames"]


def roofline_pct(rec: dict, kind: str, kernel: str):
    """The least time of the reference's `kind` work over the device time
    of the kernels whose name holds `kernel`, in %."""
    least = rec.get("work", {}).get(kind, 0.0)
    spent = sum(v for k, v in rec.get("device_s_by_name", {}).items()
                if kernel in k)
    if least <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * least / spent


def span_ms_per_frame(rec: dict, name: str):
    spans = [b - a for n, a, b in rec.get("spans", ()) if n == name]
    if not spans or not rec["frames"]:
        return None
    return 1e3 * sum(spans) / rec["frames"]
