"""Run one cell of BENCHMARK.json once:

    python3 -m fipm_bench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json: the
entry, the frames a call, the pool of frames and their file format). The
configuration names, besides its sizes, the modules that serve it, each
found by name: its scene (scenes/<scene>.py), its set-up
(setups/<setup>.py: what is learned before the window, and how an answer
reads), its plain reference (reference/<reference>.py) and its comparison
(comparisons/<compare>.py). Set-up makes the pool from the seed, learns
and drives one warm-up pass over the pool through the entry
(entries/<entry>.py). Then the window: one caller in a closed loop, each
call started when the last returned, frames from the pool in turn, each
call timed on the host clock from the entry's call until its results are
on the host, for --seconds (--trace 1: a shorter window under
torch.profiler). After the window every answer is judged against the
reference's answer for its frame, and each metric of the cell is read by
its reader (metrics/<metric>.py). The last line of standard output is the
result as one JSON object; the numbers compared, each with its limit, are
the last lines of standard error.

Exit codes: 0 with a result; 2 without the card the cell asks for; 3 when
JAX or the JAX package was loaded in the process.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "fastest_image_pattern_matching_tpu")
CACHE_DIR = ".fipm_bench_cache"


class NoChip(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark loaded from its file; a name's file may
    hold dots (metrics/device_idle_pct.one.py)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    name = "fipm_bench._by_name." + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files found by name."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: str

    def module(self, kind: str, name: str):
        return load_module(os.path.join(self.bench_dir, kind, name + ".py"))


def find_cell(root: str, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     w["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]
    return Cell(workload, w["chips"], config, traffic,
                mine(man["end_to_end"]), mine(man["per_layer"]), bench_dir)


def require_chips(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards, "
                     f"{torch.cuda.device_count()} visible")


def keep_caches_in(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(os.path.abspath(root), CACHE_DIR)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")


def seed_rng(seed: int):
    return np.random.default_rng(seed % 2**64)


@dataclasses.dataclass
class Context:
    """What an entry's prepare() gets: the port, what the configuration's
    set-up learned, the set-up's `rows` (the port's answer as the
    comparison reads it), the pool of host frames, the device, the traffic
    mix, a scratch directory under TMPDIR (removed at exit) and the list
    that takes (name, start s, end s) spans."""
    fipm: object
    learned: object
    rows: object
    pool: np.ndarray
    device: str
    traffic: dict
    workdir: str
    spans: list
    bench_dir: str

    def writer(self, fmt: str):
        return load_module(os.path.join(self.bench_dir, "scenes",
                                        fmt + ".py"))


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def window(call, first: int, seconds: float):
    """Calls in a closed loop for `seconds`: -> (answers, latencies s,
    frames, window s)."""
    answers, lat = [], []
    k = first
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out = call(k)
        te = time.perf_counter()
        lat.append(te - ts)
        answers.extend(out)
        k += 1
        if te - t0 >= seconds:
            return answers, lat, len(answers), te - t0


def quartiles(xs):
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else list(xs) * 3


def median_ms(xs):
    return round(statistics.median(xs) * 1e3, 3) if xs else None


def host_probe_ms() -> float:
    """The host's speed on a fixed loop of pure Python, printed beside
    the window: the port's calls are host bound, and the host is shared."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i * i
    return round((time.perf_counter() - t0) * 1e3, 3)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def port_builds() -> dict:
    """The port's compiler runs so far in this process (nvcc for the
    kernels, g++ for the native library): above 0 after a set-up that
    compiled, as the first run in a checkout does."""
    from fastest_image_pattern_matching_tpu_torch import native
    from fastest_image_pattern_matching_tpu_torch.ops.cuda import build
    return {"nvcc_runs": build.NVCC_RUNS, "gxx_runs": native.GXX_RUNS}


def set_up(cell: Cell, seed: int, device: str, workdir: str):
    """The pool from the seed, the configuration's set-up (setups/), the
    entry prepared and one warm-up pass over the pool. Returns (template,
    pool, call, calls made, spans, the warm-up's answers)."""
    import fastest_image_pattern_matching_tpu_torch as fipm
    rng = seed_rng(seed)
    conf, traffic = cell.config, cell.traffic
    scene = cell.module("scenes", conf["scene"])
    templ, pool, _ = scene.make_pool(conf["scene_params"], traffic["pool"],
                                     traffic["empty"], rng)
    setup = cell.module("setups", conf["setup"])
    learned = setup.learn(fipm, conf, templ, device)
    spans = []
    ctx = Context(fipm, learned, getattr(setup, "rows", None), pool, device,
                  traffic, workdir, spans, cell.bench_dir)
    call = cell.module("entries", traffic["entry"]).prepare(ctx)
    warm = -(-len(pool) // traffic["frames_per_call"])
    answers = []
    for k in range(warm):
        answers.extend(call(k))
    return templ, pool, call, warm, spans, answers


def reference_answers(cell: Cell, indices, templ, pool, device, trace=False,
                      **control):
    """The configuration's reference (reference/<reference>.py) run once
    on each pool frame of `indices`: -> ({index: answer}, {index: least
    kernel seconds by kind} when `trace`). `control` goes to the
    reference's answer()."""
    from . import roofline
    ref = cell.module("reference", cell.config["reference"])
    answers, bounds = {}, {}
    for i in sorted(set(indices)):
        work = [] if trace else None
        answers[i] = ref.answer(pool[i], templ, cell.config, device,
                                work=work, **control)
        if trace:
            bounds[i] = roofline.work_bounds(work)
    return answers, bounds


def judge(cell: Cell, answers, reference) -> dict:
    """The configuration's comparison (comparisons/<compare>.py) of the
    answers, (pool index, answer) each, against the reference's:
    {"numbers", "failed", "correct"}."""
    return cell.module("comparisons", cell.config["compare"]).judge(
        answers, reference, cell.config["limits"])


def check(cell: Cell, answers, templ, pool, device, trace=False):
    """The answers judged against the reference. Returns (verdict, least
    kernel seconds of the answers' work by kind, when `trace`)."""
    reference, bounds = reference_answers(
        cell, [i for i, _ in answers], templ, pool, device, trace)
    work = None
    if trace:
        work = {}
        for i, _ in answers:
            for kind, secs in bounds[i].items():
                work[kind] = work.get(kind, 0.0) + secs
    return judge(cell, answers, reference), work


def report(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit, in short plain names."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0"):
    """Set-up, window, check and metrics of one run of `cell` on
    `device`. Returns (result dict, numbers compared with their limits)."""
    import torch
    from . import trace as tracing

    on_card = torch.device(device).type == "cuda"
    # One host thread for torch's own CPU work: the port's calls are host
    # bound, and an idle thread pool that spins competes with them.
    torch.set_num_threads(1)
    workdir = tempfile.mkdtemp(prefix="fipm_bench_")
    try:
        builds = port_builds()
        templ, pool, call, warm, spans, _ = set_up(cell, seed, device,
                                                   workdir)
        builds = {k: v - builds[k] for k, v in port_builds().items()}
        if on_card:
            torch.cuda.synchronize(device)
        setup_s = process_age_s()
        del spans[:]
        probe = host_probe_ms()
        rec = {"setup_s": setup_s}
        if trace:
            with tracing.profiled() as box:
                answers, lat, frames, window_s = window(
                    call, warm, min(seconds, cell.traffic["trace_seconds"]))
            rec.update(tracing.reduce_events(box.pop("events")))
        else:
            answers, lat, frames, window_s = window(call, warm, seconds)
        rec.update(latencies_s=lat, frames=frames, window_s=window_s,
                   spans=list(spans))
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        del call
        half = len(lat) // 2
        sizes = [len(a) for _, a in answers]
        print(f"fipm_bench: window {window_s:.3f} s, {len(lat)} calls, "
              f"{frames} frames; call ms quartiles "
              f"{[round(q * 1e3, 3) for q in quartiles(lat)]}, first half "
              f"median {median_ms(lat[:half])}, second {median_ms(lat[half:])}"
              f"; answer sizes {min(sizes)}-{max(sizes)}; host probe "
              f"{probe} ms before the window, {host_probe_ms()} after",
              file=sys.stderr)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    verdict, rec["work"] = check(cell, answers, templ, pool, device, trace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=rec["busy_s"], window_s=window_s)
    result = {"correct": verdict["correct"], "attempted": len(answers),
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = tracing.breakdown(rec)
    # The set-up that compiled, apart: the first run in a checkout builds
    # the port's kernels and native library; later runs find them built.
    result["setup_compiled"] = dict(builds, setup_s=setup_s) \
        if any(builds.values()) else None
    checks = report(verdict["numbers"], cell.config["limits"])
    result["checks"] = checks
    return result, checks


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m fipm_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    cell = find_cell(root, args.workload)
    keep_caches_in(root)
    try:
        require_chips(cell.chips)
    except NoChip as e:
        print(f"fipm_bench: {e}", file=sys.stderr)
        return 2
    smi = smi_line()
    print(f"fipm_bench: {args.workload} seed {args.seed} on {smi} (peaks: "
          f"HBM 3.35 TB/s, int8 1979 TOP/s, f32 67 TFLOP/s, at 700 W)",
          file=sys.stderr)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"fipm_bench: the process loaded {bad}; the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    if smi:
        result["device"]["power_limit"] = smi.split(",")[-1].strip()
    result["checks"] = result.pop("checks")
    if result["setup_compiled"]:
        print(f"fipm_bench: this set-up compiled the port "
              f"({result['setup_compiled']})", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
