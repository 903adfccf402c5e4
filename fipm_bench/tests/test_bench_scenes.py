"""The scene generators: the same seed gives the same pool, every seed
the same sizes and work in another order, and the planted poses are
where the reference matcher finds them."""

import json
import os

import numpy as np
import pytest

from fipm_bench import run
from fipm_bench.reference import matcher
from fipm_bench.scenes import many_targets, rotated_parts

from conftest import TINY_PARTS, TINY_WASHERS


def pool(mod, conf, n, empty, seed):
    return mod.make_pool(conf["scene_params"], n, empty,
                         run.seed_rng(seed))


def test_rotated_parts_same_seed_same_pool():
    a = pool(rotated_parts, TINY_PARTS, 4, 1, 2**40 + 3)
    b = pool(rotated_parts, TINY_PARTS, 4, 1, 2**40 + 3)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2]


def test_rotated_parts_every_seed_the_same_poses():
    turned = []
    for seed in (1, 2, 3):
        _, frames, truths = pool(rotated_parts, TINY_PARTS, 4, 1, seed)
        assert frames.shape == (4, 240, 320) and frames.dtype == np.uint8
        assert sorted(len(t) for t in truths) == [0, 3, 3, 3]
        turned.append(sorted(round(a, 6) for t in truths for _, _, a in t))
    assert turned[0] == turned[1] == turned[2]


@pytest.mark.parametrize("seed", [11, 12])
def test_reference_finds_the_planted_parts(seed):
    templ, frames, truths = pool(rotated_parts, TINY_PARTS, 2, 0, seed)
    for frame, truth in zip(frames, truths):
        got = matcher.match(frame, templ, TINY_PARTS["match"], "cpu")
        assert len(got) == 3
        for cx, cy, ang in truth:
            d = np.hypot(got[:, 2] - cx, got[:, 3] - cy)
            k = int(np.argmin(d))
            assert d[k] < 1.0
            assert abs((got[k, 1] - ang + 180) % 360 - 180) < 1.0
            assert got[k, 0] > 0.9


def test_many_targets_spacing_and_count():
    p = TINY_WASHERS["scene_params"]
    templ, frames, truths = pool(many_targets, TINY_WASHERS, 3, 1, 21)
    assert sorted(len(t) for t in truths) == [0, p["targets"],
                                              p["targets"]]
    half = p["washer"] / 2.0
    for t in truths:
        for i, (x, y, a) in enumerate(t):
            assert a == 0.0
            assert p["margin"] <= x - half and p["margin"] <= y - half
            for x2, y2, _ in t[i + 1:]:
                assert (abs(x - x2) >= p["washer"] + p["gap"]
                        or abs(y - y2) >= p["washer"] + p["gap"])
    empty = frames[[len(t) == 0 for t in truths].index(True)]
    assert empty.max() <= p["background"]
    assert empty.min() > p["background"] - p["noise"]


def test_reference_finds_every_washer():
    templ, frames, truths = pool(many_targets, TINY_WASHERS, 1, 0, 22)
    got = matcher.match(frames[0], templ, TINY_WASHERS["match"], "cpu")
    assert len(got) == len(truths[0])
    for cx, cy, _ in truths[0]:
        assert np.min(np.hypot(got[:, 2] - cx, got[:, 3] - cy)) < 0.5


def test_the_cells_configs_draw_their_templates():
    root = os.path.dirname(run.BENCH_DIR)
    for name in ("flagship", "washers"):
        with open(os.path.join(root, "fipm_bench", "configs",
                               name + ".json")) as f:
            conf = json.load(f)
        if conf["scene"] == "rotated_parts":
            from fipm_bench.scenes import draw
            t = draw.template(conf["scene_params"]["template"],
                              run.seed_rng(1))
            assert t.shape == tuple(conf["scene_params"]["template"]["hw"])
        else:
            t = many_targets.washer(run.seed_rng(1),
                                    conf["scene_params"]["washer"])
            assert t.shape == (54, 54)
