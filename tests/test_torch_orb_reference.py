"""The port's ORB registration (models/orb.py::orb_match, the default
ORBConfig) against the benchmark's plain ORB reference
(fipm_bench/reference/orb.py) on the CPU, on small scenes of the
benchmark's own generator (fipm_bench/scenes/textured_part.py): a 240x320
frame holding a 96x128 textured part.

- the port's answer is judged by the configuration's comparison
  (comparisons/orb_results.py) within the limits of configs/orb.json;
- the configuration's control (the reference's levels resized in
  bfloat16) breaks at least one of those limits;
- the port's corners lie within 3 px of where the scene put the part;
- the reference imports neither the port nor JAX, and its copy of
  cv::ORB's bit pattern is the port's, byte for byte.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import orb as port_orb
from fipm_bench import run
from fipm_bench.reference import orb as ref
from fipm_bench.scenes import textured_part

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower.
torch.set_num_threads(1)

ROOT = os.path.dirname(run.BENCH_DIR)
with open(os.path.join(run.BENCH_DIR, "configs", "orb.json")) as f:
    CONFIG = json.load(f)
SMALL = dict(CONFIG["scene_params"], frame_hw=[240, 320],
             template=dict(CONFIG["scene_params"]["template"],
                           hw=[96, 128]),
             poses=[[160.0, 120.0, -23.0], [150.0, 115.0, 12.0],
                    [170.0, 125.0, 71.0], [165.0, 118.0, -143.0]])
SEEDS = (0, 1, 2)


def bench_module(kind, name):
    return run.load_module(os.path.join(run.BENCH_DIR, kind, name + ".py"))


@pytest.fixture(scope="module")
def cases():
    """Per seed: the scene (template, frame, true corners), the port's
    answer as the comparison reads it, the reference's answer and the
    control's."""
    setup = bench_module("setups", "orb")
    out = {}
    for seed in SEEDS:
        templ, frames, truths = textured_part.make_pool(
            SMALL, 1, 0, np.random.default_rng(seed))
        learned = setup.learn(tfipm, CONFIG, templ, "cpu")
        result = tfipm.orb_match(frames[0], templ, learned.cfg,
                                 seed=learned.seed, device="cpu")
        out[seed] = {
            "truth": truths[0], "result": result,
            "port": setup.rows(result),
            "reference": ref.answer(frames[0], templ, CONFIG, "cpu"),
            "control": ref.answer(frames[0], templ, CONFIG, "cpu",
                                  **CONFIG["controls"]["bf16_pyramid"])}
    return out


def judge(got, want):
    return bench_module("comparisons", "orb_results").judge(
        [(0, got)], {0: want}, CONFIG["limits"])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_within_the_limits_of_the_reference(cases, seed):
    c = cases[seed]
    verdict = judge(c["port"], c["reference"])
    assert verdict["correct"], verdict["numbers"]
    assert c["port"]["matched"] and c["port"]["good"] >= 10


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_pyramid_control_breaks_a_limit(cases, seed):
    c = cases[seed]
    verdict = judge(c["control"], c["reference"])
    assert not verdict["correct"], verdict["numbers"]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_corners_within_3px_of_the_truth(cases, seed):
    c = cases[seed]
    assert c["result"].is_matched
    gap = np.linalg.norm(c["result"].corners - c["truth"], axis=1).max()
    assert gap < 3.0, gap


def test_reference_loads_neither_the_port_nor_jax():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
            "import fipm_bench.reference.orb; "
            "import fipm_bench.scenes.textured_part; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = {m.split(".")[0] for m in json.loads(out.stdout)}
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax",
                       "fastest_image_pattern_matching_tpu",
                       "fastest_image_pattern_matching_tpu_torch"}


def test_bit_pattern_is_the_ports():
    port_file = os.path.join(os.path.dirname(port_orb.__file__),
                             "orb_bit_pattern.npy")
    with open(port_file, "rb") as a, open(ref.BIT_PATTERN, "rb") as b:
        assert a.read() == b.read()
