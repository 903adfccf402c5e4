"""The PyTorch port's match_arrays against the JAX package on the CPU, on
the five dry-run configs of __graft_entry__.py (base, dual-range,
fast-mode, nms-overflow, narrow) at its example sizes. The pattern crosses
over as an npz written by the JAX package. Tolerance as in
tests/test_torch_match.py: valid mask equal, score atol 1e-5, centre and
angle atol 1e-3.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import template_matcher as jtm

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as ttm)
from tests.test_torch_match import _assert_same_result

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def _example_problem(src_hw=(192, 224), templ_hw=(40, 56)):
    """The scene of __graft_entry__.py::_example_problem."""
    rng = np.random.default_rng(0)
    t = np.full(templ_hw, 30, np.uint8)
    cv2.rectangle(t, (4, 4), (templ_hw[1] - 5, templ_hw[0] - 5), 200, 2)
    cv2.line(t, (8, 8), (templ_hw[1] - 8, templ_hw[0] - 10), 255, 3)
    src = rng.integers(0, 30, size=src_hw, dtype=np.uint8)
    src[40:40 + templ_hw[0], 60:60 + templ_hw[1]] = t
    return t, src


DRYRUN_CONFIGS = {
    "base": {},
    "dual-range": dict(tolerance_ranges=(-15.0, 15.0, 165.0, 195.0)),
    "fast-mode": dict(fast_mode=True),
    "nms-overflow": dict(max_pos=16, score=0.05),
    "narrow": dict(narrow_candidates=True),
}


@pytest.mark.parametrize("tag", list(DRYRUN_CONFIGS))
def test_match_arrays_dryrun_configs(tag, tmp_path):
    """The five dry-run configs of __graft_entry__.py at its example sizes;
    the pattern crosses over as an npz written by the JAX package."""
    t, src = _example_problem()
    jp = jfipm.learn_pattern(t, 256)
    cfg = dataclasses.replace(
        jfipm.MatchConfig(max_pos=4, score=0.6, tolerance_angle=180.0),
        **DRYRUN_CONFIGS[tag])
    path = str(tmp_path / "pattern.npz")
    jp.save(path)
    want = jtm.match_arrays(src, jp, cfg)
    got = ttm.match_arrays(src, tfipm.LearnedPattern.load(path), cfg,
                           device="cpu")
    if tag != "nms-overflow":
        assert _assert_same_result(got, want) >= 1
        return
    # At score 0.05 all but the planted target are noise peaks (scores
    # 0.06-0.22) with nearly flat 3x3x3 neighbourhoods, where the subpixel
    # quadratic fit is ill-conditioned: XLA's CPU dot sums the 27-term fit
    # in another order than torch, and that last-ulp difference moves the
    # fitted point by up to ~1e-2 (measured 3.3e-3 px, 7e-3 deg; with
    # subpixel off every entry agrees within 2e-5). So: valid mask and all
    # scores as above, centre/angle atol 1e-3 for the planted target
    # (score >= 0.5), atol 1e-2 for the noise peaks.
    np.testing.assert_array_equal(got["valid"], want["valid"])
    nv = int(want["valid"].sum())
    np.testing.assert_allclose(got["score"][:nv], want["score"][:nv],
                               atol=1e-5)
    strong = want["score"][:nv] >= 0.5
    assert strong.sum() == 1
    for k in ("center", "angle"):
        np.testing.assert_allclose(got[k][:nv][strong], want[k][:nv][strong],
                                   atol=1e-3)
        np.testing.assert_allclose(got[k][:nv], want[k][:nv], atol=1e-2)
    # More above-threshold candidates than the NMS cap: the overflow
    # re-dispatch really ran.
    plan = ttm._make_plan(src.shape, tfipm.LearnedPattern.load(path), cfg)
    assert plan.nms_cap < plan.c_max and nv == cfg.max_pos
