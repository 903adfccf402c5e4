"""The PyTorch port's ops against the JAX package on the CPU.

The same numpy-seeded inputs go through each JAX function and its port;
the tolerance of every comparison is stated where it is made. The JAX
Pallas warp runs in interpret mode, as tests/test_warp_pallas.py runs it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fastest_image_pattern_matching_tpu.ops import ncc as jncc
from fastest_image_pattern_matching_tpu.ops import nms as jnms
from fastest_image_pattern_matching_tpu.ops import peaks as jpeaks
from fastest_image_pattern_matching_tpu.ops import pyramid as jpyr
from fastest_image_pattern_matching_tpu.ops import subpixel as jsub
from fastest_image_pattern_matching_tpu.ops import warp as jwarp
from fastest_image_pattern_matching_tpu.ops.pallas.warp_kernel import (
    warp_affine_pallas)
from fastest_image_pattern_matching_tpu.utils import chunking as jchunk
from fastest_image_pattern_matching_tpu.utils import geometry
from fastest_image_pattern_matching_tpu.utils import imageio as jio

import fastest_image_pattern_matching_tpu_torch  # noqa: F401  (TF32 off)
from fastest_image_pattern_matching_tpu_torch.ops import ncc as tncc
from fastest_image_pattern_matching_tpu_torch.ops import nms as tnms
from fastest_image_pattern_matching_tpu_torch.ops import peaks as tpeaks
from fastest_image_pattern_matching_tpu_torch.ops import pyramid as tpyr
from fastest_image_pattern_matching_tpu_torch.ops import subpixel as tsub
from fastest_image_pattern_matching_tpu_torch.ops import warp as twarp
from fastest_image_pattern_matching_tpu_torch.utils import chunking as tchunk
from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------------ pyramid

def _pyr_input(kind, hw, rng):
    if kind == "random":
        return rng.integers(0, 256, hw).astype(np.float32)
    if kind == "checker":
        yy, xx = np.indices(hw)
        return np.where((yy + xx) % 2 == 0, 255.0, 0.0).astype(np.float32)
    return np.full(hw, 255.0, np.float32)  # saturated


@pytest.mark.parametrize("hw", [(37, 53), (64, 48), (3, 7), (31, 2)])
@pytest.mark.parametrize("kind", ["random", "checker", "saturated"])
def test_pyramid_bit_equal(hw, kind):
    """Every level equals the JAX package's exactly (integer arithmetic
    below 2^24 in f32), on odd and even sizes and adversarial inputs."""
    img = _pyr_input(kind, hw, np.random.default_rng(11))
    want = jpyr.build_pyramid(jnp.asarray(img), 3)
    got = tpyr.build_pyramid(_t(img), 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


# --------------------------------------------------------------------- warp

def _rot_invmaps(src_hw, angles, shift=(0.0, 0.0)):
    h, w = src_hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    mats = []
    for a in angles:
        m = geometry.rotation_matrix((cx, cy), a)
        m[0, 2] += shift[0]
        m[1, 2] += shift[1]
        mats.append(geometry.invert_affine(m))
    return np.asarray(mats, np.float32)


def _assert_quantized_contract(got, ref, ref_unq):
    """|d| <= 1 on < 1e-3 of pixels, and only at .5 rounding boundaries
    (the contract of tests/test_warp_pallas.py)."""
    d = got - ref
    bad = d != 0
    assert np.abs(d).max(initial=0) <= 1
    assert bad.mean() < 1e-3, f"{bad.sum()} mismatches of {bad.size}"
    if bad.any():
        frac = np.abs(ref_unq[bad] - np.floor(ref_unq[bad]) - 0.5)
        assert frac.max() < 1e-2, "mismatch away from a .5 boundary"


@pytest.fixture(scope="module")
def warp_src():
    return np.random.default_rng(99).integers(
        0, 256, size=(200, 260)).astype(np.float32)


WARP_CASES = [
    ([0.0, 13.5, -37.25, 120.0], (0.0, 0.0), (48, 150), 64.0),
    ([7.0, -97.6, 179.0], (31.25, -12.75), (23, 30), 0.0),
    ([30.0, -150.0], (-60.0, -40.0), (264, 390), 200.0),
    ([4.0, -170.0], (-126.0, -94.0), (24, 32), 255.0),
]


@pytest.mark.parametrize("angles,shift,out_hw,border", WARP_CASES)
def test_warp_plain_vs_jax_gather(warp_src, angles, shift, out_hw, border):
    """Plain warp vs warp_affine_batch on the same maps: quantized within
    the contract, unquantized atol 5e-3 (the Pallas test's bound)."""
    inv = _rot_invmaps(warp_src.shape, angles, shift)
    args = (out_hw, border)
    ref = _np(jwarp.warp_affine_batch(jnp.asarray(warp_src), jnp.asarray(inv),
                                      *args, quantize=True))
    ref_u = _np(jwarp.warp_affine_batch(jnp.asarray(warp_src),
                                        jnp.asarray(inv), *args,
                                        quantize=False))
    got = _np(twarp.warp_affine_batch(_t(warp_src), _t(inv), *args,
                                      quantize=True))
    got_u = _np(twarp.warp_affine_batch(_t(warp_src), _t(inv), *args,
                                        quantize=False))
    _assert_quantized_contract(got, ref, ref_u)
    np.testing.assert_allclose(got_u, ref_u, atol=5e-3)


@pytest.mark.parametrize("angles,shift,out_hw,border", WARP_CASES)
def test_warp_plain_bit_equal_to_jitted_jax(warp_src, angles, shift, out_hw,
                                            border):
    """Compiled for the CPU, the JAX warp fuses its multiply-adds exactly
    where the port does (ops/rounding.py), so the two are bit-equal,
    quantized and not."""
    inv = _rot_invmaps(warp_src.shape, angles, shift)
    jitted = jax.jit(jwarp.warp_affine_batch, static_argnums=(2, 3, 4))
    for q in (True, False):
        want = _np(jitted(jnp.asarray(warp_src), jnp.asarray(inv), out_hw,
                          border, q))
        got = _np(twarp.warp_affine_batch(_t(warp_src), _t(inv), out_hw,
                                          border, quantize=q))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("angles,shift,out_hw,border", WARP_CASES[:2])
def test_warp_plain_vs_pallas_interpret(warp_src, angles, shift, out_hw,
                                        border):
    """Plain warp vs the Pallas kernel (interpret mode): quantized within
    the contract."""
    inv = _rot_invmaps(warp_src.shape, angles, shift)
    ref = _np(warp_affine_pallas(jnp.asarray(warp_src), jnp.asarray(inv),
                                 out_hw, border, quantize=True,
                                 interpret=True))
    ref_u = _np(jwarp.warp_affine_batch(jnp.asarray(warp_src),
                                        jnp.asarray(inv), out_hw, border,
                                        quantize=False))
    got = _np(twarp.warp_affine_batch(_t(warp_src), _t(inv), out_hw, border,
                                      quantize=True))
    _assert_quantized_contract(got, ref, ref_u)


def test_warp_fixed_point_frac(warp_src):
    """OpenCV-4 fixed-point coordinate mode: quantized within the
    contract."""
    inv = _rot_invmaps(warp_src.shape, [11.0, -63.0], (5.5, -2.25))
    kw = dict(out_hw=(40, 70), border_value=0.0, fixed_point_frac=True)
    ref = _np(jwarp.warp_affine_batch(jnp.asarray(warp_src),
                                      jnp.asarray(inv), quantize=True, **kw))
    ref_u = _np(jwarp.warp_affine_batch(jnp.asarray(warp_src),
                                        jnp.asarray(inv), quantize=False,
                                        **kw))
    got = _np(twarp.warp_affine_batch(_t(warp_src), _t(inv), quantize=True,
                                      **kw))
    _assert_quantized_contract(got, ref, ref_u)


def test_warp_identity_and_dispatch_on_cpu(warp_src):
    """The identity map reproduces the source exactly, and the dispatch
    sends CPU tensors to the plain version."""
    inv = _rot_invmaps(warp_src.shape, [0.0])
    got = twarp.warp_affine_dispatch(_t(warp_src), _t(inv), warp_src.shape,
                                     0.0)
    np.testing.assert_array_equal(_np(got)[0], warp_src)


def test_rotation_helpers_vs_jax():
    """make_rotation_invmaps and rotate_pt vs JAX: atol 1e-4 (the port
    rounds f64 trig to f32, JAX calls the C library's f32 trig; they
    differ by an ulp on ~1% of angles, times coordinates of ~300)."""
    rng = np.random.default_rng(5)
    ang = rng.uniform(-180, 180, 64).astype(np.float32)
    shift = rng.uniform(-300, 300, (64, 2)).astype(np.float32)
    center = (np.float32(111.5), np.float32(95.0))
    want = jwarp.make_rotation_invmaps(
        (jnp.float32(center[0]), jnp.float32(center[1])), jnp.asarray(ang),
        jnp.asarray(shift))
    got = twarp.make_rotation_invmaps(center, _t(ang), _t(shift))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    rad = ang * np.float32(np.pi / 180)
    want = jwarp.rotate_pt_jnp(jnp.asarray(shift), jnp.asarray(center),
                               jnp.asarray(rad))
    got = twarp.rotate_pt(_t(shift), torch.tensor(center), _t(rad))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


# ---------------------------------------------------------------------- ncc

@pytest.mark.parametrize("B,H,W,h,w", [(3, 30, 34, 9, 12), (2, 60, 59, 5, 7)])
def test_ccorr_conv_and_window_sums_bit_equal(B, H, W, h, w):
    """Raw centred correlation and window sums on integer inputs: exact
    (every partial sum below 2^24), so bit-equal to JAX."""
    rng = np.random.default_rng(21)
    sc = rng.integers(-128, 128, (B, H, W)).astype(np.float32)
    tc = rng.integers(-128, 128, (h, w)).astype(np.float32)
    for dt in ("int8", "f32"):
        np.testing.assert_array_equal(
            _np(tncc.ccorr_conv(_t(sc), _t(tc))),
            _np(jncc.ccorr_conv(jnp.asarray(sc), jnp.asarray(tc), dt)))
    np.testing.assert_array_equal(
        _np(tncc.window_sums(_t(sc), (h, w))),
        _np(jncc.window_sums(jnp.asarray(sc), (h, w))))
    np.testing.assert_array_equal(
        _np(tncc.window_sums(_t(sc * sc), (h, w))),
        _np(jncc.window_sums(jnp.asarray(sc * sc), (h, w))))


def test_ccorr_shiftmm_bit_equal():
    """7x7 descent correlation as one matmul: bit-equal on integers."""
    rng = np.random.default_rng(22)
    sc = rng.integers(-128, 128, (6, 29, 36)).astype(np.float32)
    tc = rng.integers(-128, 128, (23, 30)).astype(np.float32)
    want = jncc.ccorr_shiftmm(jnp.asarray(sc), jnp.asarray(tc), "int8")
    np.testing.assert_array_equal(_np(tncc.ccorr_shiftmm(_t(sc), _t(tc))),
                                  _np(want))


def _templ_stats(t):
    m = float(np.mean(t, dtype=np.float64))
    var = float(np.mean((t.astype(np.float64) - m) ** 2))
    return m, float(np.sqrt(var) * np.sqrt(t.size)), 1.0 / t.size, var < 2.2e-16


@pytest.mark.parametrize("case", ["conv", "shiftmm", "flat_src", "flat_templ"])
def test_ncc_score_map_vs_jax(case):
    """Scores atol 1e-5, through each route and each epilogue branch."""
    rng = np.random.default_rng(23)
    if case == "shiftmm":
        canv = rng.integers(0, 256, (5, 26, 33)).astype(np.float32)
        t = rng.integers(0, 256, (20, 27)).astype(np.float32)
    else:
        canv = rng.integers(0, 256, (4, 40, 44)).astype(np.float32)
        t = rng.integers(0, 256, (9, 12)).astype(np.float32)
    if case == "flat_src":
        canv[:, 5:30, 5:30] = 77.0  # diff2 under the epsilon cutoff
    if case == "flat_templ":
        t[:] = 90.0  # result_equal1 shortcut
    stats = _templ_stats(t)
    want = jncc.ncc_score_map(jnp.asarray(canv), jnp.asarray(t), *stats,
                              "int8")
    got = tncc.ncc_score_map(_t(canv), _t(t), *stats)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_ncc_tiledband_regime_takes_conv_on_cpu():
    """A map the JAX package would send to its tiled-band kernel: the CPU
    port takes the kernel's plain version, an f64 conv, and matches JAX's
    plain route (atol 1e-5); an unknown method raises."""
    rng = np.random.default_rng(24)
    canv = rng.integers(0, 256, (1, 270, 262)).astype(np.float32)
    t = rng.integers(0, 256, (6, 5)).astype(np.float32)
    stats = _templ_stats(t)
    assert tncc.auto_method(270, 262, 6, 5) == "tiledband"
    want = jncc.ncc_score_map(jnp.asarray(canv), jnp.asarray(t), *stats,
                              "f32", "conv")
    got = tncc.ncc_score_map(_t(canv), _t(t), *stats)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    with pytest.raises(ValueError):
        tncc.ncc_score_map(_t(canv), _t(t), *stats, method="fast")


# -------------------------------------------------------------------- peaks

@pytest.mark.parametrize("overlap", [0.0, 0.1, 0.8])
def test_extract_peaks_identical(overlap):
    """Values and locations identical, including planted exact ties
    (row-major first-max wins)."""
    rng = np.random.default_rng(31)
    maps = rng.uniform(-1, 1, (5, 40, 47)).astype(np.float32)
    maps[0, 10, 20] = maps[0, 30, 5] = maps[0, 10, 40] = 0.999
    maps[2, :, :] = 0.25  # all-tie map
    maps[3, 7, 9] = maps[3, 7, 10] = 1.0
    want = jpeaks.extract_peaks(jnp.asarray(maps), 9, (12, 9), overlap)
    got = tpeaks.extract_peaks(_t(maps), 9, (12, 9), overlap)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


# ----------------------------------------------------------------- subpixel

def test_subpixel_vs_jax():
    """Quadratic-fit offsets atol 1e-5, including a degenerate (flat)
    patch that must give zeros."""
    rng = np.random.default_rng(41)
    x, y, t = np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij")
    base = -(0.3 * (x - 0.2) ** 2 + 0.5 * (y + 0.1) ** 2
             + 0.4 * (t - 0.3) ** 2)
    patches = (base[None] + 0.01 * rng.standard_normal((16, 3, 3, 3))
               ).astype(np.float32)
    patches[3] = 0.5
    want = jsub.subpixel_refine(jnp.asarray(patches), jnp.float32(0.0123))
    got = tsub.subpixel_refine(_t(patches), 0.0123)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_array_equal(_np(got)[3], 0.0)


# ---------------------------------------------------------------------- nms

def _random_rects(rng, n):
    pts = rng.uniform(0, 120, (n, 2)).astype(np.float32)
    ang = rng.uniform(-180, 180, n).astype(np.float32)
    return pts, ang


def test_rotated_rect_corners_and_areas_vs_jax():
    """Corners atol 1e-3 (f32 trig ulps times 40 px sides); pair areas
    atol 1e-2 px^2 of 1200 px^2 rects."""
    rng = np.random.default_rng(51)
    pts, ang = _random_rects(rng, 24)
    qj = jnms.rotated_rect_corners(jnp.asarray(pts), jnp.asarray(ang),
                                   40.0, 30.0)
    qt = tnms.rotated_rect_corners(_t(pts), _t(ang), 40.0, 30.0)
    np.testing.assert_allclose(_np(qt), _np(qj), atol=1e-3)
    q = _np(qj)
    ia, ib = np.triu_indices(len(q), 1)
    want = np.array([float(jnms.quad_intersection_area(
        jnp.asarray(q[i]), jnp.asarray(q[j]))) for i, j in zip(ia, ib)])
    got = _np(tnms.quad_intersection_area(_t(q[ia]), _t(q[ib])))
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert (want > 0).sum() > 10  # the scene really overlaps


@pytest.mark.parametrize("overlap", [0.0, 0.1, 0.5])
def test_filter_overlaps_keep_mask_identical(overlap):
    """Greedy keep mask identical, with invalid entries interleaved."""
    rng = np.random.default_rng(52)
    pts, ang = _random_rects(rng, 40)
    pts[5] = pts[4] + 0.5  # near-duplicate pair
    ang[5] = ang[4]
    valid = rng.uniform(size=40) < 0.8
    q = _np(jnms.rotated_rect_corners(jnp.asarray(pts), jnp.asarray(ang),
                                      40.0, 30.0))
    want = jnms.filter_overlaps(jnp.asarray(q), jnp.asarray(valid), 1200.0,
                                overlap)
    got = tnms.filter_overlaps(_t(q), _t(valid), 1200.0, overlap)
    np.testing.assert_array_equal(_np(got), _np(want))


# ----------------------------------------------------------------- chunking

@pytest.mark.parametrize("pred_kind", ["none", "sorted", "interior_dead",
                                       "all_dead"])
def test_chunked_map_vs_jax(pred_kind):
    """Output identical to the JAX chunked_map, dead chunks giving zeros."""
    n, chunk = 23, 5
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    pred = {"none": None,
            "sorted": np.arange(n) < 7,
            "interior_dead": (np.arange(n) < 3) | (np.arange(n) == 17),
            "all_dead": np.zeros(n, bool)}[pred_kind]

    def jfn(args):
        (v,) = args
        return v * 2.0 + 1.0, v.sum(axis=1)

    want = jchunk.chunked_map(jfn, (jnp.asarray(x),), n, chunk,
                              pred=None if pred is None
                              else jnp.asarray(pred))
    got = tchunk.chunked_map(jfn, (_t(x),), n, chunk,
                             pred=None if pred is None else _t(pred))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


# ------------------------------------------------------------------ imageio

def test_ensure_gray_vs_jax():
    """BGR -> gray identical for uint8 numpy, float numpy and tensors."""
    rng = np.random.default_rng(61)
    img = rng.integers(0, 256, (17, 19, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tio.ensure_gray(img), jio.ensure_gray(img))
    f = img.astype(np.float32)
    np.testing.assert_array_equal(tio.ensure_gray(f), jio.ensure_gray(f))
    np.testing.assert_array_equal(_np(tio.ensure_gray(_t(f))),
                                  _np(jio.ensure_gray(jnp.asarray(f))))
    assert tio.ensure_gray(img[..., :1]).shape == (17, 19)
    with pytest.raises(ValueError):
        tio.ensure_gray(img, channel_axis_only=True)
