"""Where a benchmark cell's time goes, by the port's own spans.

    python3 tools/span_breakdown.py --workload flagship.one --seed 7 \\
        --seconds 3 [--turns 4] [--out chiprun_out/spans.json]

On the card, from the root of a checkout: the cell's set-up as
fipm_bench runs it, then a traced window under torch.profiler. The
port's span table (utils/profiling.py::spans(), on the profiler's clock)
is laid over the device trace:

  * device-idle ms a frame under each innermost fipm.* span of the
    calling thread (the idle intervals of fipm_bench/trace.py, split
    exactly over the innermost spans, "outside" where none is open), and
    under each stage (the innermost span's ancestor below the entry);
  * host self ms a frame of each span name, and the share of the entry
    spans' (fipm.match, fipm.match_many, fipm.orb) host time that their
    children cover;
  * the labels fipm_bench/trace.py gives the idle gaps, and the idle it
    leaves unnamed ("python between operators") by innermost span;
  * span sites and counter increments a frame.

--turns n: afterwards, n windows of --seconds untraced and n traced in
turns (off, on, on, off, ...): call ms p50 and p95 of each, the cost of
tracing when it is on. Prints one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fipm_bench import run, trace  # noqa: E402

ENTRIES = ("fipm.match", "fipm.match_many", "fipm.orb", "fipm.ocr",
           "fipm.corpus.batch")
# Spans that hold stages without being one: a glyph read's pattern loop
# and each pattern's stages; a batch's match inside inspect_corpus.
WRAPPERS = ("fipm.match_patterns", "fipm.patterns.pattern",
            "fipm.match_many")


def stage_of(rows, i):
    """The span's stage: its ancestor (or itself) whose parent is a call's
    entry span (ENTRIES) or, nearer, a wrapper (WRAPPERS); the entry's
    own name for an entry, and the span's top-level name outside any
    call."""
    chain = [i]
    while 0 <= rows[chain[-1]].parent < len(rows):
        chain.append(rows[chain[-1]].parent)
    for k in range(1, len(chain) - 1):
        if rows[chain[k]].name in WRAPPERS:
            return rows[chain[k - 1]].name
    return rows[chain[-2] if len(chain) > 1 else chain[-1]].name


def innermost_segments(rows, thread):
    """[(start ns, end ns, name, stage)] cutting the thread's span time
    into pieces, each named by its innermost open span and that span's
    stage."""
    mine = [i for i, r in enumerate(rows) if r.thread == thread and r.end_ns]
    cuts = sorted({t for i in mine for t in (rows[i].start_ns,
                                             rows[i].end_ns)})
    starts = sorted((rows[i].start_ns, -rows[i].end_ns, i) for i in mine)
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, (mid, 0, 0))
        for s, neg_e, i in reversed(starts[:k]):
            if -neg_e >= mid:
                segs.append((a, b, rows[i].name, stage_of(rows, i)))
                break
    return segs


def overlap_by_name(intervals, segs, key=2):
    """ns of the intervals [(a, b)] that fall in each segment's name
    (key 3: its stage)."""
    out = collections.Counter()
    starts = [s[0] for s in segs]
    for a, b in intervals:
        j = max(0, bisect.bisect_right(starts, a) - 1)
        covered = 0
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                out[segs[j][key]] += hi - lo
                covered += hi - lo
            j += 1
        out["outside"] += (b - a) - covered
    return out


def unnamed_by_span(idle, host, segs):
    """ns of the idle gaps that fipm_bench/trace.py labels "python between
    operators" (no host event within its look-back spans the gap's
    middle), by the innermost span open at the middle, and by that span
    and the host event that ended last before the middle."""
    starts = [h[0] for h in host]
    seg_starts = [s[0] for s in segs]
    out, after = collections.Counter(), collections.Counter()
    for a, b in idle:
        mid = (a + b) / 2.0
        j = bisect.bisect_right(starts, mid / 1e3) - 1
        if any(host[k][1] >= mid / 1e3
               for k in range(j, max(-1, j - trace._LOOKBACK), -1)):
            continue
        i = bisect.bisect_right(seg_starts, mid) - 1
        inside = i >= 0 and segs[i][1] >= mid
        name = segs[i][2] if inside else "outside"
        out[name] += b - a
        # The host event that ended last before the middle.
        last = max((host[k] for k in range(j, max(-1, j - 64), -1)
                    if host[k][1] < mid / 1e3), key=lambda h: h[1],
                   default=(0, 0, "none"))
        after[f"{name} after {last[2]}"] += b - a
    return out, after


def self_ms(rows):
    """Host self ns of each span name: its time less its children's."""
    child = collections.Counter()
    for r in rows:
        if r.end_ns and 0 <= r.parent < len(rows):
            child[r.parent] += r.end_ns - r.start_ns
    out = collections.Counter()
    for i, r in enumerate(rows):
        if r.end_ns:
            out[r.name] += r.end_ns - r.start_ns - child[i]
    return out


def traced(cell, call, k0, seconds, device):
    import torch
    from fastest_image_pattern_matching_tpu_torch.utils import profiling
    profiling.reset_spans()
    with trace.profiled() as box:
        answers, lat, frames, window_s = run.window(call, k0, seconds)
    events = box.pop("events")
    rows = profiling.spans()
    rec = trace.reduce_events(events)
    rec.update(frames=frames, window_s=window_s, latencies_s=lat)
    torch.cuda.synchronize(device)
    return rec, events, rows, answers


def breakdown(rec, events, rows):
    from torch.autograd import DeviceType
    frames = rec["frames"]
    win = next(e for e in events if e[0] == trace.WINDOW_SPAN
               and e[1] == DeviceType.CPU)
    w0, w1 = win[2] * 1e3, win[3] * 1e3  # ns
    busy = trace._union_us([(a, b) for _, a, b in rec["device_events"]])[1]
    edges = [w0] + [x * 1e3 for m in busy for x in m] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mine = collections.Counter(r.thread for r in rows).most_common(1)
    segs = innermost_segments(rows, mine[0][0] if mine else None)
    idle_by = overlap_by_name(idle, segs)
    idle_stage = overlap_by_name(idle, segs, key=3)
    host = [(e[2], e[3], e[0]) for e in events
            if e[1] == DeviceType.CPU and e[4] == win[4]
            and e[0] != trace.WINDOW_SPAN]
    host.sort()
    own = self_ms(rows)
    unnamed, unnamed_after = unnamed_by_span(idle, host, segs)
    entry = [i for i, r in enumerate(rows)
             if r.name in ENTRIES and r.parent < 0]
    ent_ns = sum(rows[i].end_ns - rows[i].start_ns for i in entry if
                 rows[i].end_ns)
    kids = sum(r.end_ns - r.start_ns for r in rows
               if r.end_ns and r.parent in set(entry))
    sites = collections.Counter(r.name for r in rows)
    counts = collections.Counter()
    for r in rows:
        counts.update(r.counts)

    def per_frame(c, scale=1e6):
        return {k: round(v / scale / frames, 4) for k, v in c.most_common()}

    return {
        "frames": frames, "window_s": round(rec["window_s"], 3),
        "busy_s": round(rec["busy_s"], 4),
        "idle_ms_per_frame_by_innermost_span": per_frame(idle_by),
        "idle_ms_per_frame_by_stage": per_frame(idle_stage),
        "self_ms_per_frame": per_frame(own),
        "unnamed_idle_ms_per_frame_by_innermost_span": per_frame(unnamed),
        "unnamed_idle_ms_per_frame_by_span_and_last_event": dict(
            list(per_frame(unnamed_after).items())[:24]),
        "entry_children_cover": round(kids / ent_ns, 4) if ent_ns else None,
        "idle_labels_s": dict(sorted(rec["idle_gaps_s"].items(),
                                     key=lambda kv: -kv[1])[:16]),
        "span_sites_per_frame": round(len(rows) / frames, 2),
        "sites_per_frame_by_name": per_frame(sites, 1),
        "counts_per_frame": per_frame(counts, 1),
        "device_ops_per_frame": round(len(rec["device_events"]) / frames, 2),
        "host_syncs_per_frame": round(sum(
            rec["host_counts"].get(k, 0) for k in trace.HOST_SYNCS)
            / frames, 2),
    }


def quantiles_ms(lat):
    return {"p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p95": round(float(np.percentile(lat, 95)) * 1e3, 3),
            "calls": len(lat)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--turns", type=int, default=0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    import tempfile

    import torch
    root = os.getcwd()
    cell = run.find_cell(root, a.workload)
    run.keep_caches_in(root)
    run.require_chips(cell.chips)
    torch.set_num_threads(1)
    device = "cuda:0"
    work = tempfile.mkdtemp(prefix="span_breakdown_")
    _, _, call, k, _, _ = run.set_up(cell, a.seed, device, work)
    torch.cuda.synchronize(device)
    rec, events, rows, _ = traced(cell, call, k, a.seconds, device)
    out = {"workload": a.workload, "seed": a.seed, "smi": run.smi_line(),
           **breakdown(rec, events, rows)}
    if a.turns:
        from fastest_image_pattern_matching_tpu_torch.utils import profiling
        turns = []
        for t in range(2 * a.turns):
            on = t % 4 in (1, 2)
            if on:
                with trace.profiled() as box:
                    _, lat, _, _ = run.window(call, k, a.seconds)
                box.clear()
                profiling.reset_spans()
            else:
                _, lat, _, _ = run.window(call, k, a.seconds)
            turns.append({"traced": on, **quantiles_ms(lat)})
        out["turns"] = turns
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
