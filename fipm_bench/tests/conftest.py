"""Fixtures of the benchmark's own CPU tests: a copy of the benchmark in
a temporary directory with tiny cells of its own, so that a run drives
the port and the reference on the CPU in seconds."""

import json
import os
import shutil

import pytest

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_PARTS = {
    "name": "tiny_parts", "source": "a small copy of the flagship",
    "scene": "rotated_parts",
    "scene_params": {
        "frame_hw": [240, 320], "noise": 30,
        "template": {"hw": [48, 64], "fill": 40, "noise": 25, "shapes": [
            {"rect": [6, 6, 57, 41], "val": 220, "thick": 2},
            {"disc": [21, 24, 8], "val": 180},
            {"line": [32, 8, 54, 38], "val": 255, "thick": 3},
            {"box": [8, 28, 20, 38], "val": 255}]},
        "poses": [[110.0, 90.0, 0.0], [210.0, 120.0, 120.0],
                  [150.0, 170.0, -120.0]],
        "turns": [0.0, 37.0, 71.0, -143.0, 109.0, -58.0]},
    "setup": "template", "reference": "matcher", "compare": "match_lists",
    "controls": {"bf16_scores": {"score_dtype": "bfloat16"}},
    "match": {"max_pos": 3, "score": 0.7, "tolerance_angle": 180.0,
              "max_overlap": 0.1, "use_subpixel": True,
              "min_reduce_area": 256},
    "limits": {"count_diff": 0, "score_gap": 0.0001, "centre_gap_px": 0.01,
               "angle_gap_deg": 0.01},
    "assumed": [], "reduced": []}

TINY_WASHERS = {
    "name": "tiny_washers", "source": "a small copy of Test7",
    "scene": "many_targets",
    "scene_params": {"frame_hw": [240, 240], "targets": 6, "washer": 28,
                     "background": 235, "noise": 12, "margin": 10,
                     "gap": 6},
    "setup": "template", "reference": "matcher", "compare": "match_lists",
    "controls": {"bf16_scores": {"score_dtype": "bfloat16"}},
    "match": {"max_pos": 6, "score": 0.5, "tolerance_angle": 0.0,
              "max_overlap": 0.5, "use_subpixel": True,
              "min_reduce_area": 256},
    "limits": {"count_diff": 0, "score_gap": 0.0001, "centre_gap_px": 0,
               "angle_gap_deg": 0},
    "assumed": [], "reduced": []}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path):
    """A checkout-like root: BENCHMARK.json with the real metrics and the
    tiny cells tiny.one, tiny_washers.one, tiny.batch8 and tiny.png8, and
    a copy of the benchmark whose configs/ holds the tiny configs."""
    root = tmp_path / "root"
    shutil.copytree(BENCH, root / "fipm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for conf in (TINY_PARTS, TINY_WASHERS):
        with open(root / "fipm_bench" / "configs" / (conf["name"] + ".json"),
                  "w") as f:
            json.dump(conf, f)
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"] = [
        {"name": c["name"], "source": c["source"],
         "file": f"fipm_bench/configs/{c['name']}.json", "reduced": [],
         "why": "tiny"} for c in (TINY_PARTS, TINY_WASHERS)]
    man["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
        for n, c, t in (("tiny.one", "tiny_parts", "one"),
                        ("tiny_washers.one", "tiny_washers", "one"),
                        ("tiny.batch8", "tiny_parts", "batch8"),
                        ("tiny.png8", "tiny_parts", "png8"))]
    names = {"flagship.one": "tiny.one", "washers.one": "tiny_washers.one",
             "flagship.batch8": "tiny.batch8", "flagship.png8": "tiny.png8"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[w] for w in m["workloads"]]
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(man, f, indent=1)
    return root
