"""The port's ORB path (fastest_image_pattern_matching_tpu_torch/
models/orb.py) against the JAX package's on the CPU, on the same numpy
inputs.

Tolerances, each measured on these inputs and stated with its reason:
- FAST, the 3x3 maximum, the keypoint selection of one level and the
  Hamming match: exactly equal (logic, or integer arithmetic both sides
  do exactly);
- Harris: within 1e-6 of the largest response (the box sums reach 5e7
  and det cancels, so f32 results depend on summation order; the port's
  sums are exact in f64, then rounded);
- orientation: 1e-5 rad at level 0, where both sides' moment sums are
  exact; 1e-4 rad at the resized levels, where JAX's f32 moment sums
  round and the port's (f64) do not;
- descriptors: at most 8 of 26624 bits apart (blur rounding ties; 0 were
  measured);
- pyramid levels: within 2e-3 grey of jax.image.resize, the gap recorded
  in ROADMAP queue 3 for random u8 images at 265x334 (JAX's own f32
  contraction rounds that far);
- detect_and_describe: equal with one level; with eight, at least 98% of
  the keypoints shared (ranks at a level's budget cutoff may swap);
- RANSAC on JAX's own sample table: the same inlier mask, homography
  corners within 1e-2 px;
- orb_match on JAX's sample table: is_matched equal, corners within 1 px,
  inliers within 2.
The JAX runs are shared through module-scoped fixtures.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu.models import orb as J

import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import orb as T
from tests.test_orb import _textured

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.array(a))


def _dryrun_pair(seed=5, offset=(40, 30)):
    """__graft_entry__.py's ORB scene (the template in a 200x260 noise
    scene), built the same way."""
    rng = np.random.default_rng(seed)
    otpl = np.full((80, 100), 40, np.uint8)
    cv2.rectangle(otpl, (6, 6), (93, 73), 220, 3)
    cv2.circle(otpl, (36, 40), 15, 150, -1)
    cv2.line(otpl, (12, 64), (88, 16), 255, 3)
    sc = rng.integers(0, 50, (200, 260)).astype(np.uint8)
    x, y = offset
    sc[y:y + 80, x:x + 100] = otpl
    return sc, otpl


def _jax_table(seed, iters):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed),
                                       (iters, 4), 0, 2 ** 30))


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port's orb_match draw JAX's RANSAC sample table."""
    monkeypatch.setattr(T, "_ransac_samples", lambda seed, iters, dev:
                        torch.as_tensor(_jax_table(seed, iters)).to(dev))


@pytest.fixture(scope="module")
def scene():
    return _textured(np.random.default_rng(1234), 240, 320)


@pytest.fixture(scope="module")
def levels(scene):
    """The scene's 8 pyramid levels as JAX makes them (level 0 is the
    image itself)."""
    img = scene.astype(np.float32)
    out = [img]
    for lvl in range(1, 8):
        s = 1.2 ** lvl
        out.append(np.asarray(jax.image.resize(
            jnp.asarray(img), (int(round(240 / s)), int(round(320 / s))),
            "linear")))
    return out


@pytest.fixture(scope="module")
def jax_level_feats(levels):
    """JAX's keypoints, orientations and descriptors at levels 0 and 1."""
    cfg = J.ORBConfig()
    out = {}
    for lvl in (0, 1):
        img = jnp.asarray(levels[lvl])
        pts, resp, valid = J._detect_level(img, cfg, 104)
        ang = J._orientation(img, pts)
        desc = J._descriptors(img, pts, ang)
        out[lvl] = tuple(np.asarray(a) for a in (pts, resp, valid, ang, desc))
    return out


@pytest.mark.parametrize("lvl", range(8))
def test_fast_corners_bit_equal(levels, lvl):
    img = levels[lvl]
    want = np.asarray(J._fast_corners(jnp.asarray(img), 20.0))
    got = T._fast_corners(_t(img), 20.0).numpy()
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lvl", [0, 1, 4])
def test_harris_response_within_1e6_of_max(levels, lvl):
    img = levels[lvl]
    want = np.asarray(J._harris_response(jnp.asarray(img), 0.04))
    got = T._harris_response(_t(img), 0.04).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_local_max_3x3_equal(levels):
    """On JAX's FAST-masked response (with -inf off the corners)."""
    img = jnp.asarray(levels[0])
    masked = np.asarray(jnp.where(J._fast_corners(img, 20.0),
                                  J._harris_response(img, 0.04), -jnp.inf))
    want = np.asarray(J._local_max_3x3(jnp.asarray(masked)))
    np.testing.assert_array_equal(T._local_max_3x3(_t(masked)).numpy(), want)


@pytest.mark.parametrize("lvl", [0, 1])
def test_detect_level_equal(levels, jax_level_feats, lvl):
    pts, resp, valid, _, _ = jax_level_feats[lvl]
    gp, gr, gv = (a[0].numpy() for a in T._detect_level(
        _t(levels[lvl])[None], T.ORBConfig(), 104))
    np.testing.assert_array_equal(gv, valid)
    np.testing.assert_array_equal(gp, pts)
    fin = np.isfinite(resp)
    assert np.abs(gr[fin] - resp[fin]).max() <= 1e-6 * np.abs(resp[fin]).max()


@pytest.mark.parametrize("lvl,tol", [(0, 1e-5), (1, 1e-4)])
def test_orientation_same_points(levels, jax_level_feats, lvl, tol):
    pts, _, _, ang, _ = jax_level_feats[lvl]
    got = T._orientation(_t(levels[lvl])[None], _t(pts)[None])[0].numpy()
    assert np.abs(got - ang).max() <= tol


@pytest.mark.parametrize("lvl", [0, 1])
def test_descriptor_bits_same_points_and_angles(levels, jax_level_feats,
                                                lvl):
    pts, _, _, ang, desc = jax_level_feats[lvl]
    got = T._descriptors(_t(levels[lvl])[None], _t(pts)[None],
                         _t(ang)[None])[0].numpy()
    assert set(np.unique(got)) <= {-1.0, 1.0}
    assert (got != desc).sum() <= 8


def test_resize_within_recorded_gap(levels):
    """Levels 1-7 of the textured scene, and of random u8 images of the ORB
    bench's 265x334 (the case the gap was recorded on)."""
    img = levels[0]
    for lvl in range(1, 8):
        got = T._resize(_t(img)[None], levels[lvl].shape)[0].numpy()
        assert np.abs(got - levels[lvl]).max() <= 2e-3
    rnd = np.random.default_rng(0).integers(0, 256, (265, 334)).astype(
        np.float32)
    for lvl in range(1, 8):
        hw = (round(265 / 1.2 ** lvl), round(334 / 1.2 ** lvl))
        want = np.asarray(jax.image.resize(jnp.asarray(rnd), hw, "linear"))
        got = T._resize(_t(rnd)[None], hw)[0].numpy()
        assert np.abs(got - want).max() <= 2e-3


def test_detect_and_describe_one_level_equal(scene):
    cfg = J.ORBConfig(n_levels=1, max_features=200)
    want = [np.asarray(a) for a in J.detect_and_describe(scene, cfg)]
    got = [a.numpy() for a in T.detect_and_describe(scene, cfg, device=CPU)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_detect_and_describe_eight_levels_shared(scene):
    cfg = J.ORBConfig()
    pa, da, va = (np.asarray(a) for a in jax.jit(
        lambda im: J.detect_and_describe(im, cfg))(
            jnp.asarray(scene, jnp.float32)))
    pb, db, vb = (a.numpy() for a in T.detect_and_describe(scene, cfg,
                                                           device=CPU))
    assert va.sum() == vb.sum() == 500
    ka = {tuple(p): d for p, d in zip(pa[va], da[va])}
    kb = {tuple(p): d for p, d in zip(pb[vb], db[vb])}
    shared = set(ka) & set(kb)
    assert len(shared) >= 0.98 * len(ka)
    assert sum(int((ka[k] != kb[k]).sum()) for k in shared) <= 8


def test_hamming_match_equal_with_planted_ties():
    """Integer distances tie often; duplicated template rows make the tie
    exact, and JAX's argmin takes the first index, as the port's must."""
    rng = np.random.default_rng(3)
    t = rng.choice([-1.0, 1.0], size=(40, 256)).astype(np.float32)
    t[[7, 21, 33]] = t[5]               # the same row at 5, 7, 21, 33
    t[30] = t[12]
    s = rng.choice([-1.0, 1.0], size=(60, 256)).astype(np.float32)
    s[:10] = t[[5, 12, 1, 2, 3, 4, 6, 8, 9, 10]]
    s[10:14] = -t[[5, 12, 0, 1]]
    vs = np.ones(60, bool)
    vs[[50, 55]] = False
    vt = np.ones(40, bool)
    vt[[1, 5]] = False                   # the first of the tied rows invalid
    ti_j, d_j = (np.asarray(a) for a in J.hamming_match(
        jnp.asarray(s), jnp.asarray(vs), jnp.asarray(t), jnp.asarray(vt)))
    ti_t, d_t = T.hamming_match(_t(s), _t(vs), _t(t), _t(vt))
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_array_equal(ti_t.numpy(), ti_j)
    assert ti_j[0] == 7 and ti_j[1] == 12


def test_top_k_first_matches_jax_top_k_on_ties():
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (3, 500)).astype(np.float32)
    x[:, ::7] = -np.inf
    x[1, :] = -np.inf
    x[2, 100:110] = 0.5
    for k in (1, 17, 500):
        vj, ij = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), k))
        vt, it = T._top_k_first(_t(x), k)
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_array_equal(vt.numpy(), vj)


@pytest.fixture(scope="module")
def ransac_problem():
    rng = np.random.default_rng(8)
    H_true = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0],
                       [1e-5, -2e-5, 1.0]])
    src = rng.uniform(0, 300, size=(80, 2)).astype(np.float32)
    ph = np.concatenate([src, np.ones((80, 1))], 1) @ H_true.T
    dst = (ph[:, :2] / ph[:, 2:3]).astype(np.float32)
    dst[:20] = rng.uniform(0, 300, size=(20, 2))       # 25% outliers
    valid = np.ones(80, bool)
    valid[72:] = False
    return src, dst, valid


def _corners(H, hw=(300, 300)):
    h, w = hw
    tc = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], np.float64)
    ph = tc @ np.linalg.inv(np.asarray(H, np.float64)).T
    return ph[:, :2] / ph[:, 2:3]


def test_ransac_on_jax_sample_table(ransac_problem):
    src, dst, valid = ransac_problem
    Hj, mj = (np.asarray(a) for a in J.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), 2.0, 500,
        seed=3))
    Ht, mt = T.ransac_homography(_t(src), _t(dst), _t(valid), 2.0, 500,
                                 samples=_t(_jax_table(3, 500)))
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert mj.sum() >= 50
    assert np.abs(_corners(Ht.numpy()) - _corners(Hj)).max() <= 1e-2


def test_ransac_fewer_than_four_valid_matches_jax(ransac_problem):
    """jnp.nonzero's fill of 0 past the valid count decides the draws."""
    src, dst, _ = ransac_problem
    valid = np.zeros(80, bool)
    valid[[3, 40, 61]] = True
    Hj, mj = (np.asarray(a) for a in J.ransac_homography(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), 2.0, 500,
        seed=1))
    Ht, mt = T.ransac_homography(_t(src), _t(dst), _t(valid), 2.0, 500,
                                 samples=_t(_jax_table(1, 500)))
    np.testing.assert_array_equal(mt.numpy(), mj)


def test_default_draws_depend_only_on_the_seed():
    a = T._ransac_samples(5, 100, CPU)
    assert a.shape == (100, 4) and int(a.min()) >= 0
    assert int(a.max()) < 2 ** 30
    g = torch.Generator().manual_seed(5)
    assert torch.equal(a, torch.randint(0, 2 ** 30, (100, 4), generator=g))


def _textured_pair():
    base = _textured(np.random.default_rng(21), 240, 320)
    return base, base[60:180, 80:240].copy()


PAIRS = {
    "dryrun": (_dryrun_pair,
               J.ORBConfig(max_features=150, max_good_matches=60)),
    "textured": (_textured_pair, J.ORBConfig()),
}


@pytest.fixture(scope="module")
def jax_orb():
    """JAX's orb_match on each pair (one compile each)."""
    return {name: J.orb_match(*make(), cfg)
            for name, (make, cfg) in PAIRS.items()}


@pytest.mark.parametrize("name", list(PAIRS))
def test_orb_match_vs_jax(jax_orb, jax_draws, name):
    make, cfg = PAIRS[name]
    want = jax_orb[name]
    got = T.orb_match(*make(), T.ORBConfig(**dataclasses.asdict(cfg)),
                      device=CPU)
    assert got.is_matched == want.is_matched is True
    assert abs(got.num_inliers - want.num_inliers) <= 2
    assert got.num_good_matches == want.num_good_matches
    assert np.abs(got.corners - want.corners).max() <= 1.0


def test_orb_match_finds_the_translation():
    base, tpl = _textured_pair()
    res = tfipm.orb_match(base, tpl, device=CPU)
    assert res.is_matched and res.num_inliers >= 10
    # tests/test_orb.py's bound for the JAX package on the same kind of pair
    assert np.linalg.norm(res.corners[0] - [80, 60]) < 4.0
    assert np.linalg.norm(res.corners[2] - [240, 180]) < 4.0


def test_orb_match_many_equals_per_source():
    scenes = []
    for k, off in enumerate([(40, 30), (120, 90), (10, 110)]):
        sc, tpl = _dryrun_pair(seed=30 + k, offset=off)
        scenes.append(sc)
    scenes.append(np.random.default_rng(9).integers(0, 50, (200, 260))
                  .astype(np.uint8))
    cfg = tfipm.ORBConfig(max_features=150, max_good_matches=60)
    many = tfipm.orb_match_many(np.stack(scenes), tpl, cfg, device=CPU)
    assert len(many) == 4
    for sc, r in zip(scenes, many):
        one = tfipm.orb_match(sc, tpl, cfg, device=CPU)
        for f in dataclasses.fields(r):
            a, b = getattr(r, f.name), getattr(one, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    for r, off in zip(many, [(40, 30), (120, 90), (10, 110)]):
        assert r.is_matched
        assert np.abs(r.corners[0] - off).max() < 2.0


def test_color_input_takes_the_gray_path():
    sc, tpl = _dryrun_pair()
    cfg = tfipm.ORBConfig(max_features=150, max_good_matches=60)
    gray = tfipm.orb_match(sc, tpl, cfg, device=CPU)
    color = tfipm.orb_match(np.repeat(sc[..., None], 3, -1), tpl, cfg,
                            device=CPU)
    np.testing.assert_array_equal(color.homography, gray.homography)
    with pytest.raises(ValueError):
        tfipm.orb_match_many(sc, tpl, cfg, device=CPU)


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc, tpl = _dryrun_pair()
    with pytest.raises(RuntimeError):
        tfipm.orb_match(sc, tpl)
    with pytest.raises(RuntimeError):
        tfipm.orb_match_many(sc[None], tpl)
    with pytest.raises(RuntimeError):
        T.detect_and_describe(sc, T.ORBConfig())
