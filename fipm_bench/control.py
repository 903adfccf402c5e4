"""The readings that the limits of `correct` are set from, on the card:

    python3 -m fipm_bench.control --workload <name> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out <file.jsonl>]

(control seeds are among --seeds)

For each of --seeds, the program's answers over the cell's whole pool
(set-up and its warm-up pass, as a run makes them) judged against the
reference: the lower readings. For each of --control-seeds, each control
that the configuration names under `controls` (keywords for its
reference's answer(); for the template configurations, NCC scores kept in
bfloat16, the nearest precision below the float32 they state) put in the
program's place and judged alike: the upper readings. One JSON line per
seed and kind; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from . import run


def readings(cell, seed: int, device: str, controls=()):
    """(kind, seconds, verdict) for the program and each control on one
    seed's pool."""
    out = []
    workdir = tempfile.mkdtemp(prefix="fipm_bench_")
    try:
        t0 = time.perf_counter()
        templ, pool, call, _, _, answers = run.set_up(cell, seed, device,
                                                      workdir)
        del call
        verdict, _ = run.check(cell, answers, templ, pool, device)
        out.append(("program", time.perf_counter() - t0, verdict))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name in controls:
        t0 = time.perf_counter()
        ctrl, _ = run.reference_answers(
            cell, [i for i, _ in answers], templ, pool, device,
            **cell.config["controls"][name])
        verdict, _ = run.check(cell, list(ctrl.items()), templ, pool,
                               device)
        out.append((name, time.perf_counter() - t0, verdict))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m fipm_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--controls", nargs="*",
                   help="names under the configuration's `controls` "
                        "(default: all)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out")
    args = p.parse_args(argv)
    root = os.getcwd()
    run.keep_caches_in(root)
    cell = run.find_cell(root, args.workload)
    if args.device.startswith("cuda"):
        try:
            run.require_chips(cell.chips)
        except run.NoChip as e:
            print(f"fipm_bench.control: {e}", file=sys.stderr)
            return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            ctrl = ()
            if seed in args.control_seeds:
                ctrl = args.controls or sorted(cell.config["controls"])
            for kind, secs, v in readings(cell, seed, args.device, ctrl):
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "kind": kind, "seconds": secs,
                                   "correct": v["correct"],
                                   "numbers": v["numbers"]})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    bad = run.forbidden_modules()
    if bad:
        print(f"fipm_bench.control: the process loaded {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
