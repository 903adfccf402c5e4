"""The PyTorch port's main path against the JAX package on the CPU.

learn_pattern, the static plan and match_arrays end to end, with the
pattern handed across by pattern_from_reference and by an npz round-trip.
End-to-end tolerance (the sharded-vs-single one of __graft_entry__.py):
valid mask equal, score atol 1e-5, centre and angle atol 1e-3.
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

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def _make_template(rng, h=48, w=64):
    """The structured template of tests/test_match_synthetic.py."""
    t = np.full((h, w), 40, np.uint8)
    cv2.rectangle(t, (6, 6), (w - 7, h - 7), 220, 2)
    cv2.circle(t, (w // 3, h // 2), 8, 180, -1)
    cv2.line(t, (w // 2, 8), (w - 10, h - 10), 255, 3)
    cv2.putText(t, "R", (8, h - 12), cv2.FONT_HERSHEY_SIMPLEX, 0.9, 255, 2)
    return cv2.add(t, rng.integers(0, 25, size=t.shape, dtype=np.uint8))


def _paste_rotated(scene, templ, cx, cy, angle_deg):
    h, w = templ.shape
    diag = int(np.ceil(np.hypot(h, w))) + 4
    canvas = np.zeros((diag, diag), np.uint8)
    mask = np.zeros((diag, diag), np.uint8)
    y0, x0 = (diag - h) // 2, (diag - w) // 2
    canvas[y0:y0 + h, x0:x0 + w] = templ
    mask[y0:y0 + h, x0:x0 + w] = 255
    m = cv2.getRotationMatrix2D(((diag - 1) / 2, (diag - 1) / 2), angle_deg, 1)
    rc = cv2.warpAffine(canvas, m, (diag, diag), flags=cv2.INTER_LINEAR)
    rm = cv2.warpAffine(mask, m, (diag, diag), flags=cv2.INTER_NEAREST)
    ys = int(round(cy - (diag - 1) / 2))
    xs = int(round(cx - (diag - 1) / 2))
    region = scene[ys:ys + diag, xs:xs + diag]
    region[rm > 0] = rc[rm > 0]


@pytest.fixture(scope="module")
def template():
    return _make_template(np.random.default_rng(7))


def _scene(name, template):
    """(scene, template, config) of the tests/test_match_synthetic.py
    scenes."""
    h, w = template.shape
    if name == "single_no_rotation":
        scene = np.random.default_rng(3).integers(0, 30, (300, 400), np.uint8)
        scene[101:101 + h, 150:150 + w] = template
        return scene, template, jfipm.MatchConfig(
            max_pos=5, score=0.7, tolerance_angle=0.0)
    if name == "multi_no_rotation":
        scene = np.random.default_rng(4).integers(0, 30, (400, 500), np.uint8)
        for (y, x) in [(30, 40), (200, 60), (90, 300), (300, 380),
                       (310, 150)]:
            scene[y:y + h, x:x + w] = template
        return scene, template, jfipm.MatchConfig(
            max_pos=8, score=0.8, tolerance_angle=0.0, max_overlap=0.2)
    if name.startswith("rotated"):
        angle = float(name.split("_")[1])
        scene = np.random.default_rng(5).integers(0, 30, (360, 440), np.uint8)
        _paste_rotated(scene, template, 220.0, 180.0, angle)
        return scene, template, jfipm.MatchConfig(
            max_pos=3, score=0.6, tolerance_angle=180.0)
    if name == "three_rotated":
        scene = np.random.default_rng(6).integers(0, 30, (500, 600), np.uint8)
        for (cx, cy, a) in [(150.0, 130.0, 0.0), (430.0, 160.0, 120.0),
                            (280.0, 380.0, -120.0)]:
            _paste_rotated(scene, template, cx, cy, a)
        return scene, template, jfipm.MatchConfig(
            max_pos=3, score=0.5, tolerance_angle=180.0, max_overlap=0.1)
    if name in ("fast_mode", "bitwise_not"):
        scene = np.random.default_rng(8).integers(0, 30, (300, 400), np.uint8)
        scene[60:60 + h, 90:90 + w] = template
        if name == "bitwise_not":
            return (255 - scene).astype(np.uint8), template, \
                jfipm.MatchConfig(max_pos=2, score=0.5, tolerance_angle=0.0,
                                  bitwise_not=True)
        return scene, template, jfipm.MatchConfig(
            max_pos=2, score=0.5, tolerance_angle=0.0, fast_mode=True)
    if name == "no_match":
        scene = np.random.default_rng(9).integers(0, 255, (200, 200), np.uint8)
        return scene, template, jfipm.MatchConfig(
            max_pos=3, score=0.9, tolerance_angle=0.0)
    rng = np.random.default_rng(1234)
    if name == "tiny_fast_mode":
        t = np.full((20, 24), 30, np.uint8)
        cv2.rectangle(t, (2, 2), (21, 17), 220, 2)
        cv2.line(t, (4, 4), (20, 16), 255, 2)
        scene = rng.integers(0, 30, size=(200, 260), dtype=np.uint8)
        scene[50:70, 80:104] = t
        scene[120:140, 180:204] = t
        return scene, t, jfipm.MatchConfig(
            max_pos=4, score=0.5, tolerance_angle=0.0, fast_mode=True)
    assert name == "tiny_no_pyramid"
    t = np.full((14, 16), 30, np.uint8)
    cv2.rectangle(t, (1, 1), (14, 12), 220, 2)
    scene = rng.integers(0, 30, size=(120, 150), dtype=np.uint8)
    scene[40:54, 60:76] = t
    return scene, t, jfipm.MatchConfig(max_pos=3, score=0.6,
                                       tolerance_angle=0.0)


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    nv = int(want["valid"].sum())
    np.testing.assert_allclose(got["score"][:nv], want["score"][:nv],
                               atol=1e-5)
    np.testing.assert_allclose(got["center"][:nv], want["center"][:nv],
                               atol=1e-3)
    np.testing.assert_allclose(got["angle"][:nv], want["angle"][:nv],
                               atol=1e-3)
    return nv


SCENES = ["single_no_rotation", "multi_no_rotation", "rotated_-37.0",
          "rotated_101.0", "three_rotated", "fast_mode", "bitwise_not",
          "no_match", "tiny_fast_mode", "tiny_no_pyramid"]


@pytest.mark.parametrize("name", SCENES)
def test_match_arrays_synthetic_scenes(name, template):
    """The synthetic scenes end to end, pattern via
    pattern_from_reference."""
    scene, t, cfg = _scene(name, template)
    jp = jfipm.learn_pattern(t, 256)
    want = jtm.match_arrays(scene, jp, cfg)
    got = ttm.match_arrays(scene, tfipm.pattern_from_reference(jp), cfg,
                           device="cpu")
    nv = _assert_same_result(got, want)
    assert nv == 0 if name == "no_match" else nv >= 1


@pytest.mark.parametrize("roi,regions", [
    (None, None),
    ((3, 5, 50, 36), None),
    (None, [np.array([[2, 2], [30, 4], [20, 25]], np.float32)]),
])
def test_learn_pattern_levels_bit_equal(template, roi, regions):
    """Levels bit-equal, stats equal, border colour, roi and regions."""
    jp = jfipm.learn_pattern(template, 256, roi=roi, regions=regions)
    tp = tfipm.learn_pattern(template, 256, roi=roi, regions=regions,
                             device="cpu")
    assert len(tp.levels) == len(jp.levels)
    for a, b in zip(tp.levels, jp.levels):
        np.testing.assert_array_equal(a.templ, b.templ)
        assert (a.mean, a.norm, a.inv_area, a.result_equal1) == \
            (b.mean, b.norm, b.inv_area, b.result_equal1)
    assert (tp.border_color, tp.min_reduce_area, tp.roi) == \
        (jp.border_color, jp.min_reduce_area, jp.roi)
    assert len(tp.regions) == len(jp.regions)
    for a, b in zip(tp.regions, jp.regions):
        np.testing.assert_array_equal(a, b)


def test_pattern_npz_roundtrip_both_ways(template, tmp_path):
    """The port reads the JAX package's npz and writes one it reads."""
    regions = [np.array([[1, 1], [9, 2], [5, 8]], np.float32)]
    jp = jfipm.learn_pattern(template, 256, roi=(2, 2, 60, 44),
                             regions=regions)
    jp.save(str(tmp_path / "j.npz"))
    tp = tfipm.LearnedPattern.load(str(tmp_path / "j.npz"))
    tp.save(str(tmp_path / "t.npz"))
    back = jfipm.LearnedPattern.load(str(tmp_path / "t.npz"))
    for p in (tp, back):
        for a, b in zip(p.levels, jp.levels):
            np.testing.assert_array_equal(a.templ, b.templ)
            assert a.mean == b.mean and a.norm == b.norm
        assert p.roi == jp.roi and p.border_color == jp.border_color
        np.testing.assert_array_equal(p.regions[0], jp.regions[0])


@pytest.mark.parametrize("cfg_kw", [
    dict(tolerance_angle=180.0),
    dict(tolerance_angle=0.0, fast_mode=True),
    dict(tolerance_ranges=(-15.0, 15.0, 165.0, 195.0), max_pos=16),
    dict(tolerance_angle=30.0, max_candidates=40),
])
def test_plan_and_sweep_arrays_equal(template, cfg_kw):
    """_make_plan and _top_sweep_arrays give identical plans and maps."""
    cfg = jfipm.MatchConfig(**cfg_kw)
    jp = jfipm.learn_pattern(template, 256)
    tp = tfipm.pattern_from_reference(jp)
    for hw in [(300, 400), (501, 333)]:
        pj = jtm._make_plan(hw, jp, cfg)
        pt = ttm._make_plan(hw, tp, cfg)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        for a, b in zip(ttm._top_sweep_arrays(pt), jtm._top_sweep_arrays(pj)):
            np.testing.assert_array_equal(a, b)


def test_match_results_and_template_matcher(template):
    """match() returns the same MatchResults (regions projected), and
    TemplateMatcher drives the same path."""
    scene, t, cfg = _scene("rotated_101.0", template)
    reg = [np.array([[0, 0], [10, 0], [10, 10]], np.float32)]
    jp = jfipm.learn_pattern(t, 256, regions=reg)
    want = jfipm.match(scene, jp, cfg)
    got = tfipm.match(scene, tfipm.pattern_from_reference(jp), cfg,
                      device="cpu")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.center, w.center, atol=1e-3)
        np.testing.assert_allclose(g.regions[0], w.regions[0], atol=1e-2)
    m = tfipm.TemplateMatcher(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        m.match(scene)
    m.learn_pattern(t)
    res = m.match(scene)
    assert len(res) == len(want) and abs(res[0].score - want[0].score) <= 1e-5
    m.set_min_reduce_area(1024)
    assert m.pattern is None


def test_input_guards(template):
    """The JAX package's input guards, and an explicit device."""
    pat = tfipm.learn_pattern(template, 256, device="cpu")
    cfg = tfipm.MatchConfig()
    with pytest.raises(ValueError):
        tfipm.match(np.zeros((20, 20), np.uint8), pat, cfg, device="cpu")
    with pytest.raises(ValueError):
        tfipm.match(np.full((100, 100), 300.0), pat, cfg, device="cpu")
    color = np.stack([np.zeros((100, 120), np.uint8)] * 3, -1)
    assert tfipm.match(color, pat, cfg, device="cpu") == []
