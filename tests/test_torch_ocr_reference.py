"""The port's glyph read (MultiTemplateMatcher.match_all with cross-glyph
NMS, then read_string, as the benchmark's entry read_plate drives them)
against the benchmark's plain OCR reference (fipm_bench/reference/ocr.py)
on the CPU, on small plates of the benchmark's own generator
(fipm_bench/scenes/glyph_plate.py): 10 glyphs of the 5x7 font at 52x34,
4 of them stamped on a 120x320 plate.

- the port's read is judged by the configuration's comparison
  (comparisons/glyph_reads.py) within the limits of configs/ocr.json;
- the configuration's control (the reference's NCC scores kept in
  bfloat16) breaks at least one of those limits;
- the port's string is the one stamped on the plate, and the suppression
  across glyphs takes look-alike matches off;
- the reference imports neither the port nor JAX.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import fastest_image_pattern_matching_tpu_torch as tfipm
from fipm_bench import run
from fipm_bench.reference import ocr as ref
from fipm_bench.scenes import glyph_plate

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower.
torch.set_num_threads(1)

ROOT = os.path.dirname(run.BENCH_DIR)
with open(os.path.join(run.BENCH_DIR, "configs", "ocr.json")) as f:
    CONFIG = json.load(f)
# Look-alike glyphs (0 and O, 8 and B, 1 and I) among them.
SMALL = dict(CONFIG["scene_params"], frame_hw=[120, 320],
             glyphs="0O8B1IMX25", length=4, first=None, y0=34)
SEEDS = (0, 1, 2)


def bench_module(kind, name):
    return run.load_module(os.path.join(run.BENCH_DIR, kind, name + ".py"))


@pytest.fixture(scope="module")
def cases():
    """Per seed: the stamped string, the port's read as the comparison
    takes it, its matches before the suppression, the reference's read
    and the control's."""
    setup = bench_module("setups", "glyphs")
    out = {}
    for seed in SEEDS:
        glyphs, frames, truths = glyph_plate.make_pool(
            SMALL, 1, 0, run.seed_rng(seed))
        learned = setup.learn(tfipm, CONFIG, glyphs, "cpu")
        ctx = run.Context(tfipm, learned, setup.rows, frames, "cpu", {},
                          "", [], run.BENCH_DIR)
        call = bench_module("entries", "read_plate").prepare(ctx)
        out[seed] = {
            "truth": truths[0], "port": call(0)[0][1],
            "all": learned.matcher.match_all(frames[0]),
            "reference": ref.answer(frames[0], glyphs, CONFIG, "cpu"),
            "control": ref.answer(frames[0], glyphs, CONFIG, "cpu",
                                  **CONFIG["controls"]["bf16_scores"])}
    return out


def judge(got, want):
    return bench_module("comparisons", "glyph_reads").judge(
        [(0, got)], {0: want}, CONFIG["limits"])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_within_the_limits_of_the_reference(cases, seed):
    c = cases[seed]
    verdict = judge(c["port"], c["reference"])
    assert verdict["correct"], verdict["numbers"]
    assert len(c["port"]["rows"]) >= len(c["truth"])


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_scores_control_breaks_a_limit(cases, seed):
    c = cases[seed]
    verdict = judge(c["control"], c["reference"])
    assert not verdict["correct"], verdict["numbers"]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_reads_the_stamped_string(cases, seed):
    c = cases[seed]
    assert c["port"]["text"] == c["reference"]["text"] == c["truth"]


def test_cross_nms_takes_look_alikes_off(cases):
    kept = [len(cases[s]["port"]["rows"]) for s in SEEDS]
    found = [len(cases[s]["all"]) for s in SEEDS]
    assert all(k <= n for k, n in zip(kept, found))
    assert sum(kept) < sum(found), (kept, found)


def test_reference_loads_neither_the_port_nor_jax():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
            "import fipm_bench.reference.ocr; "
            "import fipm_bench.scenes.glyph_plate; "
            "import fipm_bench.run as run, os; "
            "run.load_module(os.path.join(run.BENCH_DIR, 'comparisons', "
            "'glyph_reads.py')); "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = {m.split(".")[0] for m in json.loads(out.stdout)}
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax",
                       "fastest_image_pattern_matching_tpu",
                       "fastest_image_pattern_matching_tpu_torch"}
