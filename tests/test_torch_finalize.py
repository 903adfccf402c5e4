"""The port's finalize (build_stages(...).finalize) must be independent of
candidate array order, as the JAX package's is
(tests/test_finalize_order_invariance.py): the invariant that makes the
angle-sharded descent, which reorders candidates, equal to the unsharded
one, even under exact score ties (the position-based lexicographic
tie-break). The same ties and 5 permutations, one frame (frame index 0,
n_frames 1), held also against the JAX package's finalize."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import (
    template_matcher as jtm)

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as ttm)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stages():
    t = np.full((24, 32), 128, np.uint8)
    t[4:20, 6:26] = 40
    cfg = tfipm.MatchConfig(max_pos=6, score=0.5, tolerance_angle=0.0,
                            max_overlap=0.3)
    pat = tfipm.learn_pattern(t, 256, device="cpu")
    plan = ttm._make_plan((200, 220), pat, cfg)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in pat.levels)
    jpat = jfipm.learn_pattern(t, 256)
    jcfg = jfipm.MatchConfig(max_pos=6, score=0.5, tolerance_angle=0.0,
                             max_overlap=0.3)
    jplan = jtm._make_plan((200, 220), jpat, jcfg)
    jstats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                   for lv in jpat.levels)
    return (ttm.build_stages(plan, stats, "cpu"), plan,
            jtm.build_stages(jplan, jstats))


def _finalize(st, pt, ang, score, alive):
    out = st.finalize(torch.from_numpy(pt), torch.from_numpy(ang),
                      torch.from_numpy(score), torch.from_numpy(alive),
                      torch.zeros(len(score), dtype=torch.long), 1)
    return {k: v[0].numpy() for k, v in out.items()
            if k in ("score", "angle", "center", "valid")}


def _ties(C):
    pt = np.zeros((C, 2), np.float32)
    ang = np.zeros(C, np.float32)
    score = np.full(C, -1.0, np.float32)
    alive = np.zeros(C, bool)
    # Five candidates with exactly tied scores; two pairs overlap, so the
    # greedy keep set depends on the order unless the tie-break is
    # position-based.
    locs = [(10.0, 10.0), (14.0, 12.0),     # overlapping tie pair
            (80.0, 40.0), (84.0, 42.0),     # overlapping tie pair
            (150.0, 120.0)]                 # isolated
    for i, (x, y) in enumerate(locs):
        pt[i] = (x, y)
        score[i] = 0.875
        alive[i] = True
    return pt, ang, score, alive


def test_exact_ties_resolve_identically_under_permutation(stages):
    st, plan, jst = stages
    C = plan.c_max
    pt, ang, score, alive = _ties(C)
    ref = _finalize(st, pt, ang, score, alive)
    for seed in range(5):
        perm = np.random.default_rng(seed).permutation(C)
        out = _finalize(st, pt[perm], ang[perm], score[perm], alive[perm])
        for k in ("score", "angle", "center", "valid"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # The tie-break kept exactly one of each overlapping pair.
    assert int(ref["valid"].sum()) == 3
    jout = jst.finalize(jnp.asarray(pt), jnp.asarray(ang),
                        jnp.asarray(score), jnp.asarray(alive))
    np.testing.assert_array_equal(ref["valid"], np.asarray(jout["valid"]))
    v = ref["valid"]
    np.testing.assert_allclose(ref["center"][v],
                               np.asarray(jout["center"])[v], atol=1e-3)
    np.testing.assert_allclose(ref["score"][v],
                               np.asarray(jout["score"])[v], atol=1e-5)
