"""Nothing the benchmark loads is JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), the reference loads nothing of the port, and a run without
the card, or without the port, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from fipm_bench import run

ROOT = os.path.dirname(run.BENCH_DIR)
JAX_PKG = "fastest_image_pattern_matching_tpu"
PORT = JAX_PKG + "_torch"

LOAD_ALL = f"""
import glob, json, os, sys
sys.path.insert(0, {ROOT!r})
import fipm_bench.run as run, fipm_bench.control, fipm_bench.trace
import fipm_bench.roofline, fipm_bench.readers
for kind in ("entries", "metrics", "scenes", "setups", "reference",
             "comparisons"):
    for p in sorted(glob.glob(os.path.join(run.BENCH_DIR, kind, "*.py"))):
        run.load_module(p)
import fastest_image_pattern_matching_tpu_torch
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import fipm_bench.run
import glob, os
import fipm_bench.reference.matcher
for p in sorted(glob.glob(os.path.join({ROOT!r}, "fipm_bench",
                                       "comparisons", "*.py"))):
    fipm_bench.run.load_module(p)
import fipm_bench.scenes.rotated_parts, fipm_bench.scenes.many_targets
import fipm_bench.roofline
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in json.loads(out.stdout)}


def test_harness_and_port_load_no_jax():
    tops = loaded(LOAD_ALL)
    assert PORT in tops
    assert not tops & {"jax", "jaxlib", "flax", JAX_PKG}


def test_reference_loads_nothing_of_the_port():
    tops = loaded(LOAD_REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", JAX_PKG, PORT}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN))
    monkeypatch.setitem(sys.modules, JAX_PKG + ".ops", sys)
    assert JAX_PKG in run.forbidden_modules()


def no_result(cwd):
    out = subprocess.run(
        [sys.executable, "-m", "fipm_bench", "--workload", "flagship.one",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    return out


def test_no_card_no_result():
    out = no_result(ROOT)
    assert out.returncode == 2 and "CUDA" in out.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.BENCH_DIR, tmp_path / "fipm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    no_result(tmp_path)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "fipm_bench", "--workload", "flagship.one",
         "--seed", "77", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
