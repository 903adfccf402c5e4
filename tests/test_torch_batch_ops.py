"""The ops that gained a frame axis for the port's batched serving path
(the warp's source index, the stacked pyramid, the per-frame NMS), against
the port's own per-frame runs and the JAX package on the CPU, and the
port's one-phase run against the JAX package's two-phase dispatch. Split from tests/test_torch_batch.py, whose
module-scoped JAX runs these tests do not use, so that the parallel test
run can place the two files on different workers.

Tolerances: the ops exactly; a JAX config with two_phase=True against
the default to score 1e-6, centre and angle 1e-5 (the same arithmetic),
against JAX to
the ROADMAP's valid masks equal, score 1e-5, centre and angle 1e-3.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import template_matcher as jtm

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.ops import nms as tnms
from fastest_image_pattern_matching_tpu_torch.ops import pyramid as tpyr
from fastest_image_pattern_matching_tpu_torch.ops import warp as twarp
from tests.test_config_knobs import _build_scene
from tests.test_torch_batch import _same_own
from tests.test_torch_match import _assert_same_result

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


@pytest.mark.parametrize("quantize", [True, False])
def test_warp_source_index_equals_loop(quantize):
    """The plain warp on a stack of sources with a source index equals a
    loop over the sources, map by map, exactly."""
    rng = np.random.default_rng(5)
    srcs = torch.as_tensor(rng.integers(0, 256, (3, 50, 70)).astype(
        np.float32))
    maps = torch.as_tensor(np.stack([
        [[np.cos(a), -np.sin(a), 5.0 + a], [np.sin(a), np.cos(a), -3.0]]
        for a in rng.uniform(-3, 3, 7)]).astype(np.float32))
    idx = torch.as_tensor([2, 0, 1, 1, 2, 0, 2])
    got = twarp.warp_affine_batch(srcs, maps, (31, 45), 17.0, quantize,
                                  src_index=idx)
    want = torch.cat([twarp.warp_affine_batch(srcs[f], maps[i:i + 1],
                                              (31, 45), 17.0, quantize)
                      for i, f in enumerate(idx.tolist())])
    assert torch.equal(got, want)
    disp = twarp.warp_affine_dispatch(srcs, maps, (31, 45), 17.0, quantize,
                                      src_index=idx)
    assert torch.equal(disp, want)
    with pytest.raises(ValueError, match="src_index"):
        twarp.warp_affine_batch(srcs, maps, (31, 45), 17.0)


@pytest.mark.parametrize("hw", [(37, 52), (64, 64), (5, 9)])
def test_pyr_down_stack_equals_per_frame(hw):
    rng = np.random.default_rng(6)
    stack = torch.as_tensor(rng.integers(0, 256, (3,) + hw).astype(
        np.float32))
    stack[1] = 255.0
    stack[2, ::2, ::2] = 0.0
    got = tpyr.build_pyramid(stack, 2)
    for f in range(3):
        for a, b in zip(got, tpyr.build_pyramid(stack[f], 2)):
            assert torch.equal(a[f], b)


@pytest.mark.parametrize("overlap", [0.0, 0.3])
def test_filter_overlaps_frames_equal_per_frame(overlap):
    """The frame axis of the NMS: each frame's keep mask equals its own
    [C] run (pairs only within a frame), exactly."""
    rng = np.random.default_rng(7)
    N, C = 4, 30
    pts = torch.as_tensor(rng.uniform(0, 80, (N, C, 2)).astype(np.float32))
    ang = torch.as_tensor(rng.uniform(-180, 180, (N, C)).astype(np.float32))
    quads = tnms.rotated_rect_corners(pts, ang, 40.0, 30.0)
    valid = torch.as_tensor(rng.uniform(size=(N, C)) < 0.7)
    valid[2] = False
    got = tnms.filter_overlaps(quads, valid, 1200.0, overlap)
    for f in range(N):
        assert torch.equal(got[f], tnms.filter_overlaps(quads[f], valid[f],
                                                        1200.0, overlap))
    assert not got[2].any() and got.any()


@pytest.fixture(scope="module")
def two_phase_scene():
    """tests/test_config_knobs.py's 96x96 scene (3 targets at 10, -25 and
    0 deg in 420x460) and its configuration."""
    rng = np.random.default_rng(3)
    tpl = np.full((96, 96), 60, np.uint8)
    cv2.rectangle(tpl, (8, 8), (87, 87), 200, 6)
    cv2.circle(tpl, (48, 48), 22, 240, -1)
    cv2.line(tpl, (12, 80), (80, 16), 20, 5)
    tpl = cv2.add(tpl, rng.integers(0, 15, tpl.shape, dtype=np.uint8))
    scene = _build_scene(rng, tpl, [(110.0, 120.0, 10.0),
                                    (300.0, 140.0, -25.0),
                                    (180.0, 320.0, 0.0)])
    jp = jfipm.learn_pattern(tpl, 256)
    cfg = jfipm.MatchConfig(max_pos=5, score=0.7, tolerance_angle=30.0,
                            max_overlap=0.2)
    return scene, jp, tfipm.pattern_from_reference(jp), cfg


def test_two_phase_vs_default_and_jax(two_phase_scene):
    """The port runs in one phase: given the JAX package's config with
    two_phase=True (an attribute the port does not read), it equals its
    own default and JAX's two-phase result, whose plan has a split
    layer."""
    scene, jp, tp, cfg = two_phase_scene
    cfg2 = dataclasses.replace(cfg, two_phase=True)
    stats = tuple((lv.mean, lv.norm, lv.inv_area, lv.result_equal1)
                  for lv in jp.levels)
    assert jtm._stage_split(jtm._make_plan(scene.shape, jp, cfg2),
                            jtm._stats_key(stats)) is not None
    two = tfipm.match_arrays(scene, tp, cfg2, device="cpu")
    one = tfipm.match_arrays(scene, tp, cfg, device="cpu")
    _same_own(two, one)
    assert int(two["valid"].sum()) == 3
    _assert_same_result(two, jtm.match_arrays(scene, jp, cfg2))


def test_two_phase_empty_scene(two_phase_scene):
    """No candidate alive after phase A: the empty result, like JAX's."""
    _, jp, tp, cfg = two_phase_scene
    cfg2 = dataclasses.replace(cfg, two_phase=True)
    noise = np.random.default_rng(8).integers(0, 40, size=(420, 460),
                                              dtype=np.uint8)
    got = tfipm.match_arrays(noise, tp, cfg2, device="cpu")
    want = jtm.match_arrays(noise, jp, cfg2)
    assert not got["valid"].any()
    for k in ("score", "angle", "center", "corners", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
