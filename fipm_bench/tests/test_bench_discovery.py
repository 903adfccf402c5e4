"""The harness finds every piece of a cell by its name, and a later
change adds a configuration, a traffic mix, an entry and metrics as new
files and new manifest entries only."""

import json
import os

import numpy as np

from fipm_bench import run

ROOT = os.path.dirname(run.BENCH_DIR)


def test_every_cell_finds_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for w in man["workloads"]:
        cell = run.find_cell(ROOT, w["name"])
        cell.module("scenes", cell.config["scene"])
        assert callable(cell.module("setups", cell.config["setup"]).learn)
        assert callable(cell.module("reference",
                                    cell.config["reference"]).answer)
        assert callable(cell.module("comparisons",
                                    cell.config["compare"]).judge)
        assert set(cell.config["controls"])
        cell.module("entries", cell.traffic["entry"])
        if "file" in cell.traffic:
            cell.module("scenes", cell.traffic["file"]["format"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.module("metrics", m["name"]).read)


DUMMY_ENTRY = '''"""Two pool frames a call, the later first, through
match()."""


def prepare(ctx):
    pool = ctx.pool

    def call(k):
        out = []
        for i in (1, 0):
            res = ctx.fipm.match(pool[i], ctx.learned.pattern,
                                 ctx.learned.cfg, device=ctx.device)
            out.append((i, ctx.rows(res)))
        return out
    return call
'''
DUMMY_E2E = '''def read(rec):
    return float(len(rec["latencies_s"]))
'''
DUMMY_LAYER = '''def read(rec):
    return rec["frames"] / 2.0 if rec.get("frames") else None
'''


def test_a_dummy_of_each_added_as_files(tiny_root):
    bench = tiny_root / "fipm_bench"
    with open(bench / "configs" / "tiny_parts.json") as f:
        conf = json.load(f)
    conf["name"] = "dummy_cfg"
    conf["match"]["max_pos"] = 2
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(conf))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"entry": "dummy_entry", "frames_per_call": 2, "pool": 2,
         "empty": 0, "trace_seconds": 1}))
    (bench / "entries" / "dummy_entry.py").write_text(DUMMY_ENTRY)
    (bench / "metrics" / "dummy_calls.py").write_text(DUMMY_E2E)
    (bench / "metrics" / "dummy_layer.one.py").write_text(DUMMY_LAYER)
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_cfg", "source": "a dummy",
                           "file": "fipm_bench/configs/dummy_cfg.json",
                           "reduced": [], "why": "dummy"})
    man["workloads"].append({"name": "dummy.two", "config": "dummy_cfg",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "dummy"})
    man["end_to_end"].append({"name": "dummy_calls", "unit": "calls",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["dummy.two"]})
    man["per_layer"].append({"name": "dummy_layer.one", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "dummy_calls",
                             "workloads": ["dummy.two"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = run.find_cell(str(tiny_root), "dummy.two", str(bench))
    assert [m["name"] for m in cell.per_layer] == ["dummy_layer.one"]
    assert {m["name"] for m in cell.end_to_end} == {"dummy_calls",
                                                    "setup_s"}
    result, checks = run.run_cell(cell, 99, 0.2, False, "cpu")
    assert result["correct"], checks
    assert result["attempted"] == 2 * result["metrics"]["dummy_calls"][
        "value"]
    layer = cell.module("metrics", "dummy_layer.one")
    assert layer.read({"frames": 6}) == 3.0 and layer.read({}) is None


# A configuration of another kind: the best spot of the port's plain
# score map (match_template), with a set-up, a reference and a comparison
# of its own, all new files.
SPOT_SETUP = '''"""The template as it is: match_template learns nothing."""
import numpy as np


def learn(fipm, config, templ, device):
    return templ


def rows(score_map):
    y, x = np.unravel_index(int(np.argmax(score_map)), score_map.shape)
    return np.array([float(score_map[y, x]), y, x], np.float64)
'''
SPOT_ENTRY = '''def prepare(ctx):
    pool = ctx.pool

    def call(k):
        i = k % len(pool)
        m = ctx.fipm.match_template(pool[i], ctx.learned, method="conv",
                                    device=ctx.device)
        return [(i, ctx.rows(m))]
    return call
'''
SPOT_REFERENCE = '''"""TM_CCOEFF_NORMED by brute force in f64 numpy."""
import numpy as np


def answer(frame, templ, config, device, work=None):
    f = frame.astype(np.float64)
    t = templ.astype(np.float64) - templ.mean()
    win = np.lib.stride_tricks.sliding_window_view(f, templ.shape)
    num = np.einsum("ijkl,kl->ij", win, t)
    mean = win.mean(axis=(2, 3))
    var = (win ** 2).mean(axis=(2, 3)) - mean ** 2
    den = np.sqrt(np.maximum(var, 0) * t.size) * np.sqrt((t ** 2).sum())
    m = num / np.maximum(den, 1e-12)
    y, x = np.unravel_index(int(np.argmax(m)), m.shape)
    return np.array([m[y, x], y, x], np.float64)
'''
SPOT_COMPARE = '''def judge(answers, reference, limits):
    moved = max(abs(a[1:] - reference[i][1:]).sum() for i, a in answers)
    gap = max(abs(a[0] - reference[i][0]) for i, a in answers)
    numbers = {"spot_moved_px": float(moved), "score_gap": float(gap)}
    bad = any(numbers[k] > limits[k] for k in numbers)
    return {"numbers": numbers, "failed": len(answers) if bad else 0,
            "correct": not bad}
'''


def test_a_dummy_of_another_kind_added_as_files(tiny_root):
    bench = tiny_root / "fipm_bench"
    with open(bench / "configs" / "tiny_parts.json") as f:
        conf = json.load(f)
    conf.update(name="dummy_spot", setup="dummy_spot",
                reference="dummy_ncc", compare="dummy_spot",
                controls={"none": {}},
                limits={"spot_moved_px": 0, "score_gap": 1e-4})
    del conf["match"]
    (bench / "configs" / "dummy_spot.json").write_text(json.dumps(conf))
    (bench / "traffic" / "dummy_spot_one.json").write_text(json.dumps(
        {"entry": "dummy_spot", "frames_per_call": 1, "pool": 2,
         "empty": 0, "trace_seconds": 1}))
    (bench / "setups" / "dummy_spot.py").write_text(SPOT_SETUP)
    (bench / "entries" / "dummy_spot.py").write_text(SPOT_ENTRY)
    (bench / "reference" / "dummy_ncc.py").write_text(SPOT_REFERENCE)
    (bench / "comparisons" / "dummy_spot.py").write_text(SPOT_COMPARE)
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy_spot", "source": "a dummy",
                           "file": "fipm_bench/configs/dummy_spot.json",
                           "reduced": [], "why": "dummy"})
    man["workloads"].append({"name": "dummy_spot.one",
                             "config": "dummy_spot",
                             "traffic": "dummy_spot_one", "chips": 1,
                             "why": "dummy"})
    for m in man["end_to_end"]:
        if m["name"] == "latency_p95_ms":
            m["workloads"].append("dummy_spot.one")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = run.find_cell(str(tiny_root), "dummy_spot.one", str(bench))
    result, checks = run.run_cell(cell, 5, 0.2, False, "cpu")
    assert result["correct"], checks
    assert set(checks) == {"spot_moved_px", "score_gap"}
    assert set(result["metrics"]) == {"latency_p95_ms", "setup_s"}
    # Its own comparison fails an answer moved by one pixel.
    spot = cell.module("comparisons", "dummy_spot")
    want = {0: np.array([0.9, 10.0, 12.0])}
    assert spot.judge([(0, want[0])], want, conf["limits"])["correct"]
    moved = [(0, np.array([0.9, 10.0, 13.0]))]
    assert not spot.judge(moved, want, conf["limits"])["correct"]
