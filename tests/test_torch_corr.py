"""The port's large-map correlation path against the JAX package on the CPU.

The plain version of the correlation kernel (ops/ncc.py::ccorr_tiled_ref),
the method routing and scores of ncc_score_map in the kernel's regime, the
peaks of one large map against JAX's tiled BlockMax form, ccorr_fft,
match_template (also against an f64 score map), match_candidates and
match_arrays on a many-target scene. The JAX Pallas tiled-band kernel runs
in interpret mode, as tests/test_corr_kernel.py runs it; on the CPU the JAX
package's own route for this regime is its banded form. Inputs are made
from numpy seeds; every tolerance is stated where it is used.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import fastest_image_pattern_matching_tpu as jfipm
from fastest_image_pattern_matching_tpu.models import template_matcher as jtm
from fastest_image_pattern_matching_tpu.ops import ncc as jncc
from fastest_image_pattern_matching_tpu.ops import peaks as jpeaks
from fastest_image_pattern_matching_tpu.ops.pallas.corr_kernel import (
    ccorr_tiledband_pallas)

import chip_smoke
import fastest_image_pattern_matching_tpu_torch as tfipm
from fastest_image_pattern_matching_tpu_torch.models import (
    template_matcher as ttm)
from fastest_image_pattern_matching_tpu_torch.ops import ncc as tncc
from fastest_image_pattern_matching_tpu_torch.ops import peaks as tpeaks
from fastest_image_pattern_matching_tpu_torch.utils import profiling
from tests.test_torch_match import _assert_same_result

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _centred(shape, seed):
    B, H, W, h, w = shape
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 256, (B, H, W)).astype(np.float32) - 128.0
    T = rng.integers(0, 256, (h, w)).astype(np.float32) - 128.0
    return S, T


def _templ_stats(t):
    m = float(np.mean(t, dtype=np.float64))
    var = float(np.mean((t.astype(np.float64) - m) ** 2))
    return m, float(np.sqrt(var) * np.sqrt(t.size)), 1.0 / t.size, var < 2.2e-16


# ------------------------------------------------------------- correlation

@pytest.mark.parametrize("shape", [
    (1, 300, 333, 27, 27),   # Test7 top-layer geometry
    (2, 140, 150, 5, 13),    # batched, asymmetric
    (1, 100, 300, 8, 129),   # widest template
])
def test_ccorr_tiled_ref_bit_equal_to_pallas_interpret(shape):
    """Plain version vs the Pallas kernel (int8, interpret mode): both are
    exact on integer inputs, so bit-equal."""
    S, T = _centred(shape, shape[0] * shape[1] + shape[3])
    want = np.asarray(ccorr_tiledband_pallas(jnp.asarray(S), jnp.asarray(T),
                                             "int8", interpret=True))
    got = tncc.ccorr_tiled_ref(_t(S), _t(T)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [
    (1, 90, 200, 64, 129),   # both eligibility bounds at once
    (1, 40, 60, 1, 2),       # the smallest template the kernel takes
    (3, 50, 41, 7, 2),       # w = 2, batched
])
def test_ccorr_tiled_ref_bit_equal_at_eligibility_corners(shape):
    """The corners of the kernel's template range against the JAX
    package's int8 conv (int32 accumulation, exact): bit-equal. (The
    Pallas kernel in interpret mode takes about a minute to trace the
    64x129 corner, so its exactness there rests on the same int8
    reference, tests/test_corr_kernel.py.)"""
    S, T = _centred(shape, 17 + shape[3])
    want = np.asarray(jncc.ccorr_conv(jnp.asarray(S), jnp.asarray(T),
                                      "int8"))
    got = tncc.ccorr_tiled_ref(_t(S), _t(T)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ccorr_tiled_dispatch_on_cpu_and_eligibility():
    """CPU tensors take the plain version and launch nothing; templates
    the kernel does not take raise on every device."""
    S, T = _centred((2, 70, 80, 9, 11), 3)
    before = profiling.counter("corr.launches")
    assert torch.equal(tncc.ccorr_tiled(_t(S), _t(T)),
                       tncc.ccorr_tiled_ref(_t(S), _t(T)))
    assert profiling.counter("corr.launches") == before
    for h, w in ((65, 9), (9, 130), (9, 1)):
        with pytest.raises(ValueError):
            tncc.ccorr_tiled(_t(S), torch.zeros((h, w)))


@pytest.mark.parametrize("shape", [(1, 120, 150, 27, 27), (3, 64, 90, 5, 40)])
def test_ccorr_fft_vs_jax(shape):
    """FFT correlation vs JAX's: atol 1e-6 of the largest |output| (both
    are f32 FFTs, whose rounding grows with log N times the output's
    scale)."""
    S, T = _centred(shape, 29)
    want = np.asarray(jncc.ccorr_fft(jnp.asarray(S), jnp.asarray(T)))
    got = tncc.ccorr_fft(_t(S), _t(T)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------- routing, score

@pytest.mark.parametrize("H,W,h,w,route", [
    (40, 44, 9, 12, "conv"),         # small map
    (26, 33, 20, 27, "shiftmm"),     # Ho*Wo <= 512
    (300, 333, 27, 27, "tiledband"),  # the many-target top layer
    (400, 400, 64, 129, "tiledband"),  # both bounds
    (300, 333, 65, 27, "conv"),      # too tall: JAX's banded form -> conv
    (300, 400, 20, 130, "conv"),     # too wide
    (1500, 1500, 350, 350, "conv"),  # large template, below the crossover
    (1500, 1500, 400, 400, "fft"),   # and past it
])
def test_auto_method_routes(H, W, h, w, route):
    """method="auto" on the JAX package's rules: where JAX takes its banded
    form (too tall or too wide for the kernel), conv; large templates over
    large areas go to fft past the rule's crossover."""
    assert tncc.auto_method(H, W, h, w) == route


@pytest.mark.parametrize("shape", [(1, 300, 333, 27, 27), (3, 280, 290, 9, 40)])
def test_ncc_score_map_kernel_regime_vs_jax(shape):
    """Scores in the kernel's regime (the port: plain version of the
    kernel; JAX on the CPU: its exact int8 banded form), atol 1e-5, and
    the explicit names of the route."""
    B, H, W, h, w = shape
    rng = np.random.default_rng(31)
    canv = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    t = rng.integers(0, 256, (h, w)).astype(np.float32)
    stats = _templ_stats(t)
    assert tncc.auto_method(H, W, h, w) == "tiledband"
    want = np.asarray(jncc.ncc_score_map(jnp.asarray(canv), jnp.asarray(t),
                                         *stats, "int8"))
    for method in ("auto", "tiledband", "banded"):
        got = tncc.ncc_score_map(_t(canv), _t(t), *stats, method=method)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError):
        tncc.ncc_score_map(_t(canv), _t(t[:, :1]), *stats,
                           method="tiledband")


# -------------------------------------------------------------------- peaks

def _peak_maps(seed, hw=(300, 333)):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 0.9, hw).astype(np.float32)
    Hs, Ws = hw
    # Planted exact ties, in one tile and across tiles, and peaks whose
    # suppression rects cross the map edges.
    for y, x in ((10, 20), (10, 21), (150, Ws - 33), (40, 5), (150, 140),
                 (0, 0), (Hs - 1, Ws - 1), (0, Ws - 1), (Hs - 1, 0)):
        m[y, x] = 0.999
    m[200:230, 50:90] = 0.95   # a plateau: ties everywhere inside
    m[:3, 100:200] = -1.0      # pre-masked
    return m


@pytest.mark.parametrize("overlap", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("entry", ["tiled", "dispatch"])
def test_extract_peaks_tiled_identical(overlap, entry):
    """One large map (A == 1, H*W >= 65536, where the JAX package takes its
    tiled BlockMax form): the port's masked loop gives vals and locs
    identical to JAX's tiled form, called directly on a batch of two copies
    of the map, and through JAX's extract_peaks dispatch on one."""
    m = _peak_maps(41)
    k, tw, th = 40, 27, 27
    if entry == "dispatch":
        want = jpeaks.extract_peaks(jnp.asarray(m)[None], k, (tw, th),
                                    overlap)
        want = (np.asarray(want[0])[0], np.asarray(want[1])[0])
        got = tpeaks.extract_peaks(_t(m)[None], k, (tw, th), overlap)
        got = (got[0][0], got[1][0])
    else:
        sw = int(2 * tw * (1 - overlap))
        sh = int(2 * th * (1 - overlap))
        want = jpeaks._extract_peaks_tiled(
            jnp.asarray(m), k, sw, sh, tw * (1.0 - overlap),
            th * (1.0 - overlap))
        got = tpeaks.extract_peaks(_t(np.stack([m, m])), k, (tw, th),
                                   overlap)
        np.testing.assert_array_equal(got[0][0].numpy(), got[0][1].numpy())
        got = (got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32


def test_extract_peaks_tiled_tall_rect_and_masked_path_agree():
    """A rect taller than wide (TH and TW from different rules in JAX's
    tiled form) on a map that is not a tile multiple: JAX's tiled form and
    the port's masked loop, on one map and on a batch of two, give the same
    peaks."""
    m = _peak_maps(43, (257, 300))
    k, sw, sh = 30, 40, 90
    want = jpeaks._extract_peaks_tiled(jnp.asarray(m), k, sw, sh, 20.0, 45.0)
    for maps in (m[None], np.stack([m, m])):
        got = tpeaks.extract_peaks(_t(maps), k, (20, 45), 0.0)
        for a in range(maps.shape[0]):
            np.testing.assert_array_equal(got[0][a].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1][a].numpy(),
                                          np.asarray(want[1]))


# -------------------------------------------------------------- entry points

def _ncc_f64(src, templ):
    """TM_CCOEFF_NORMED in f64 with numpy alone: the raw correlation by an
    f64 FFT rounded to the exact integer, window sums from int64 integral
    images. Away from flat windows it is the exact score to ~1e-15."""
    S, T = src.astype(np.float64), templ.astype(np.float64)
    H, W = S.shape
    h, w = T.shape
    cc = np.fft.irfft2(np.fft.rfft2(S) * np.conj(np.fft.rfft2(T, s=(H, W))),
                       s=(H, W))
    cc = np.rint(cc[:H - h + 1, :W - w + 1])

    def wsum(x):
        c = np.zeros((H + 1, W + 1), np.int64)
        c[1:, 1:] = x.cumsum(0).cumsum(1)
        return (c[h:, w:] - c[:-h, w:] - c[h:, :-w]
                + c[:-h, :-w]).astype(np.float64)

    s1 = wsum(src.astype(np.int64))
    s2 = wsum(src.astype(np.int64) ** 2)
    area = h * w
    tm = T.mean()
    tn = np.sqrt(np.mean((T - tm) ** 2) * area)
    return (cc - tm * s1) / (np.sqrt(s2 - s1 * s1 / area) * tn)


@pytest.mark.parametrize("case", ["tiled_auto", "conv_auto", "fft"])
def test_match_template_vs_jax(case):
    """The no-pyramid score map on full-range u8 input vs JAX's
    match_template, atol 1e-5: an eligible small template over a big map
    (the kernel's route), a large 90x100 template (conv) and
    method="fft". Both are also held against an f64 score map: the exact
    routes (kernel, conv) to atol 1e-7, a few f32 ulps of the epilogue
    (their sums are exact; measured 6.5e-9 for the port, 5.5e-9 for JAX),
    fft to 1e-6 (its f32 transform rounds the correlation by ~1e-7
    relative; measured 6e-8)."""
    rng = np.random.default_rng(51)
    src = rng.integers(0, 256, (300, 340), dtype=np.uint8)
    if case == "tiled_auto":
        templ = src[100:120, 50:74].copy()
        assert tncc.auto_method(300, 340, 20, 24) == "tiledband"
    else:
        # Window sums of S*T pass 2^24 here: an f32 convolution would no
        # longer be exact (ROADMAP.md, queue 3).
        templ = src[40:130, 60:160].copy()
        assert tncc.auto_method(300, 340, 90, 100) == "conv"
    method = "fft" if case == "fft" else "auto"
    want = np.asarray(jfipm.match_template(src, templ, method))
    got = tfipm.match_template(src, templ, method, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    exact = _ncc_f64(src, templ)
    atol = 1e-6 if case == "fft" else 1e-7
    np.testing.assert_allclose(got, exact, atol=atol)
    np.testing.assert_allclose(want, exact, atol=atol)
    assert np.unravel_index(np.argmax(got), got.shape) == (
        (100, 50) if case == "tiled_auto" else (40, 60))


@pytest.fixture(scope="module")
def many_target():
    """chip_smoke.py's many-target scene at 720x720 with 20 washers, and
    the pattern learnt by the JAX package."""
    scene, templ, truth = chip_smoke.many_target_scene(720, 20)
    return scene, jfipm.learn_pattern(templ, 1024), truth


@pytest.mark.parametrize("tol", [0.0, 30.0])
def test_match_candidates_vs_jax(many_target, tol):
    """The top-layer candidate dump: alive mask equal, scores atol 1e-5,
    positions and angles atol 1e-3."""
    scene, jp, _ = many_target
    cfg = chip_smoke.many_target_config(jfipm, 20, tol)
    want = jtm.match_candidates(scene, jp, cfg)
    got = ttm.match_candidates(scene, tfipm.pattern_from_reference(jp), cfg,
                               device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["alive"], want["alive"])
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-5)
    for k in ("x", "y", "angle"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    assert got["alive"].sum() >= 20


@pytest.mark.parametrize("tol", [0.0, 30.0])
def test_match_arrays_many_target_scene(many_target, tol):
    """Test7's configuration on 20 planted washers: tol=0 takes the tiled
    correlation on one canvas, tol=30 the tiled correlation
    on a batch of rotated canvases. Valid mask equal, score atol 1e-5,
    centre and angle atol 1e-3; every planted washer found."""
    scene, jp, truth = many_target
    cfg = chip_smoke.many_target_config(jfipm, 20, tol)
    tp = tfipm.pattern_from_reference(jp)
    plan = ttm._make_plan(scene.shape, tp, cfg)
    Hc, Wc = plan.canvas_hw
    th, tw = plan.templ_shapes[plan.top]
    assert tncc.auto_method(Hc, Wc, th, tw) == "tiledband"
    assert (len(plan.angles) == 1) == (tol == 0.0)
    want = jtm.match_arrays(scene, jp, cfg)
    got = ttm.match_arrays(scene, tp, cfg, device="cpu")
    assert _assert_same_result(got, want) == 20
    for cx, cy in truth:
        d = np.hypot(got["center"][:, 0] - cx, got["center"][:, 1] - cy)
        assert d.min() <= 0.05
