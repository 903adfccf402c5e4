"""The port's kernel modules and import rules.

On the CPU: the kernel modules import without nvcc, CPU tensors take the
plain versions, the wrappers raise on what their kernels do not take, and
no port source imports JAX or the JAX package, nor cv2 but inside the
functions that draw the CLI's overlays, write ORB records as YAML/XML and
grab camera frames.
Tests marked `cuda`
compare the hand-written kernels with their plain versions on the card and
skip without one.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu_torch.ops import ncc as tncc
from fastest_image_pattern_matching_tpu_torch.ops import warp as twarp
from fastest_image_pattern_matching_tpu_torch.ops.cuda import (corr_kernel,
                                                           warp_kernel)
from fastest_image_pattern_matching_tpu_torch.utils import device as tdevice
from fastest_image_pattern_matching_tpu_torch.utils import geometry
from fastest_image_pattern_matching_tpu_torch.utils import profiling

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fastest_image_pattern_matching_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "cv2", "fastest_image_pattern_matching_tpu")
# As in the JAX package, cv2 draws the CLI's --output-image overlays,
# writes ORB records as .yml/.xml and grabs camera frames: these modules may
# import it inside a function, never at module level (the card's machine
# has no cv2).
LAZY_CV2 = (os.path.join(PORT, "cli.py"),
            os.path.join(PORT, "utils", "serialization.py"),
            os.path.join(PORT, "utils", "sources.py"))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_no_jax_cv2_or_jax_package():
    """Parse every port source: no import of jax or the JAX package at
    any depth of the module, and of cv2 none but inside a function of the
    LAZY_CV2 modules."""
    srcs = _port_sources()
    assert len(srcs) > 10
    for path in srcs:
        tree = ast.parse(open(path).read(), path)
        in_function = {id(node) for fn in ast.walk(tree)
                       if isinstance(fn, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                       for node in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                lazy_cv2 = (top == "cv2" and path in LAZY_CV2
                            and id(node) in in_function)
                assert top not in FORBIDDEN or lazy_cv2, (path, n)


def _maps(src_hw, angles, shift):
    h, w = src_hw
    mats = []
    for a in angles:
        m = geometry.rotation_matrix(((w - 1) / 2.0, (h - 1) / 2.0), a)
        m[0, 2] += shift[0]
        m[1, 2] += shift[1]
        mats.append(geometry.invert_affine(m))
    return torch.as_tensor(np.asarray(mats, np.float32))


def test_kernel_module_imports_without_nvcc_and_cpu_takes_plain():
    """Importing, in a fresh process with no nvcc reachable, builds and
    loads nothing; CPU tensors take the plain version and launch no
    kernel."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    code = ("import fastest_image_pattern_matching_tpu_torch.ops.cuda."
            "warp_kernel as w; from fastest_image_pattern_matching_tpu_torch."
            "utils.profiling import counter; assert w._LIB is None and "
            "counter('warp.launches') == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    src = torch.as_tensor(np.random.default_rng(2).integers(
        0, 256, (60, 80)).astype(np.float32))
    maps = _maps(src.shape, [0.0, 33.0, -120.0], (3.5, -2.0))
    before = profiling.counter("warp.launches")
    got = twarp.warp_affine_dispatch(src, maps, (30, 41), 17.0)
    want = twarp.warp_affine_batch(src, maps, (30, 41), 17.0, quantize=True)
    assert torch.equal(got, want)
    assert profiling.counter("warp.launches") == before


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA entry point raises instead of falling back to the plain
    version."""
    src = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        warp_kernel.warp_affine_cuda(src, _maps((8, 8), [0.0], (0, 0)),
                                     (4, 4), 0.0)


def test_cuda_device_without_card_raises(monkeypatch):
    """Asking for CUDA without a card raises; nothing falls back to the
    CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("out_hw,B,border", [((68, 70), 41, 255.0),
                                             ((23, 30), 24, 0.0),
                                             ((527, 768), 6, 0.0)])
def test_warp_kernel_matches_plain_on_card(cuda_device, out_hw, B, border):
    """Kernel vs plain version on the card: quantized output bit-equal,
    unquantized atol 5e-3 (the same f32 ops in the same order; the plain
    version's f64-evaluated FMAs can differ by a double rounding, about
    2^-29 of operations)."""
    rng = np.random.default_rng(4)
    src = torch.as_tensor(rng.integers(0, 256, (759, 1006)).astype(
        np.float32), device=cuda_device)
    maps = _maps(src.shape, rng.uniform(-180, 180, B),
                 (rng.uniform(-200, 200), rng.uniform(-200, 200)))
    maps = maps.to(cuda_device)
    before = profiling.counter("warp.launches")
    for q in (True, False):
        got = twarp.warp_affine_dispatch(src, maps, out_hw, border, q)
        want = twarp.warp_affine_batch(src, maps, out_hw, border, quantize=q)
        torch.cuda.synchronize()
        if q:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
    assert profiling.counter("warp.launches") == before + 2


def _check_warp_on_card(src, maps, out_hw, border):
    """Kernel vs plain on the card: quantized bit-equal, unquantized atol
    5e-3 (see test_warp_kernel_matches_plain_on_card); returns the number
    of blocks that read their taps from global memory."""
    warp_kernel.global_tap_blocks(reset=True)
    for q in (True, False):
        got = warp_kernel.warp_affine_cuda(src, maps, out_hw, border, q)
        want = twarp.warp_affine_batch(src, maps, out_hw, border, quantize=q)
        torch.cuda.synchronize()
        if q:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
    return warp_kernel.global_tap_blocks(reset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", [0.0, 45.0, 90.0])
def test_warp_kernel_staged_at_angle_on_card(cuda_device, angle):
    """Level-0 sizes (6 ROIs of 527x768 from 3036x4024), every map at one
    angle: the staged branch takes every block and matches the plain
    version."""
    rng = np.random.default_rng(int(angle) + 1)
    src = torch.as_tensor(rng.integers(0, 256, (3036, 4024)).astype(
        np.float32), device=cuda_device)
    mats = []
    for x, y in rng.uniform(0, 2500, (6, 2)):
        m = geometry.rotation_matrix((x + 383.5, y + 263.0), angle)
        mats.append(geometry.invert_affine(m) @ np.array(
            [[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]]))
    maps = torch.as_tensor(np.asarray(mats, np.float32)[:, :2],
                           device=cuda_device).contiguous()
    assert _check_warp_on_card(src, maps, (527, 768), 0.0) == 0


@pytest.mark.cuda
def test_warp_kernel_tile_outside_image_on_card(cuda_device):
    """Maps that put every tile wholly outside the image give the border
    value everywhere, through the staged branch."""
    src = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (300, 400)).astype(np.float32), device=cuda_device)
    maps = torch.tensor([[[0.8, 0.6, -5000.0], [-0.6, 0.8, 40.0]],
                         [[1.0, 0.0, 30.0], [0.0, 1.0, 9000.5]]],
                        device=cuda_device)
    assert _check_warp_on_card(src, maps, (70, 90), 17.0) == 0
    got = warp_kernel.warp_affine_cuda(src, maps, (70, 90), 17.0, True)
    assert bool((got == 17.0).all())


@pytest.mark.cuda
def test_warp_kernel_large_footprint_on_card(cuda_device):
    """General affine maps (scale about 3) exceed the staging buffer: every
    block reads its taps from global memory, counted, with the same
    result as the plain version."""
    src = torch.as_tensor(np.random.default_rng(6).integers(
        0, 256, (600, 900)).astype(np.float32), device=cuda_device)
    maps = torch.tensor([[[3.0, 0.4, 10.5], [-0.3, 2.5, 20.25]],
                         [[-2.7, 1.1, 800.0], [0.9, 2.9, 5.0]]],
                        device=cuda_device)
    n_blocks = 2 * 2 * 3 * 5  # two launches, 2 maps of 3x5 full tiles
    assert _check_warp_on_card(src, maps, (96, 160), 3.0) == n_blocks


@pytest.mark.cuda
def test_tiledband_regime_launches_kernel_on_card(cuda_device):
    """Where the JAX package takes its tiled-band kernel, the card launches
    the correlation kernel once; its correlation is bit-equal to the plain
    version's on the card, and the scores agree with the port on the CPU
    to 1e-6 (the same exact sums and IEEE epilogue on both)."""
    rng = np.random.default_rng(8)
    canv = torch.as_tensor(rng.integers(0, 256, (1, 300, 300)).astype(
        np.float32), device=cuda_device)
    t = torch.as_tensor(rng.integers(0, 256, (5, 6)).astype(np.float32),
                        device=cuda_device)
    stats = (float(t.double().mean()), 1234.5, 1 / 30.0, False)
    assert tncc.auto_method(300, 300, 5, 6) == "tiledband"
    before = profiling.counter("corr.launches")
    got = tncc.ncc_score_map(canv, t, *stats)
    torch.cuda.synchronize()
    assert profiling.counter("corr.launches") == before + 1
    want = tncc.ncc_score_map(canv.cpu(), t.cpu(), *stats)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)
    sc, tc = canv - 128.0, t - 128.0
    assert torch.equal(tncc.ccorr_tiled(sc, tc), tncc.ccorr_tiled_ref(sc, tc))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1824, 1824, 27, 27),
                                   (8, 300, 310, 27, 27),
                                   (1, 200, 400, 64, 129),
                                   (2, 97, 131, 1, 2),
                                   (3, 70, 1000, 13, 2)])
def test_corr_kernel_matches_plain_on_card(cuda_device, shape):
    """Kernel vs plain version on the card: bit-equal on integer inputs;
    on fractional inputs within the kernel's rounding bound, elementwise
    (w + 1) * 2^-24 * sum |S||T| over the window, plus one f32 ulp of the
    result."""
    B, H, W, h, w = shape
    rng = np.random.default_rng(B + h)
    S = torch.as_tensor(rng.integers(-128, 128, (B, H, W)).astype(np.float32),
                        device=cuda_device)
    T = torch.as_tensor(rng.integers(-128, 128, (h, w)).astype(np.float32),
                        device=cuda_device)
    before = profiling.counter("corr.launches")
    got = corr_kernel.ccorr_valid_cuda(S, T)
    want = tncc.ccorr_tiled_ref(S, T)
    torch.cuda.synchronize()
    assert profiling.counter("corr.launches") == before + 1
    assert torch.equal(got, want)
    Sf = S + torch.as_tensor(rng.uniform(-0.5, 0.5, S.shape).astype(
        np.float32), device=cuda_device)
    got = corr_kernel.ccorr_valid_cuda(Sf, T)
    want = tncc.ccorr_tiled_ref(Sf, T)
    bound = ((w + 1) * 2.0**-24 * tncc.ccorr_tiled_ref(Sf.abs(), T.abs())
             .double() + 2.0**-23 * want.double().abs())
    assert bool(((got.double() - want.double()).abs() <= bound).all())


@pytest.mark.cuda
def test_corr_kernel_mixed_blocks_on_card(cuda_device):
    """One launch over an integer canvas with a fractional patch: the
    blocks that stage the patch take the f32 path, the others the int8
    path; outputs whose window misses the patch are bit-equal to the plain
    version, the others within the f32 path's rounding bound."""
    rng = np.random.default_rng(21)
    S = torch.as_tensor(rng.integers(-128, 128, (1, 700, 900)).astype(
        np.float32), device=cuda_device)
    S[0, 300:320, 400:440] += 0.5
    T = torch.as_tensor(rng.integers(-128, 128, (27, 27)).astype(
        np.float32), device=cuda_device)
    corr_kernel.path_blocks(reset=True)
    got = corr_kernel.ccorr_valid_cuda(S, T)
    want = tncc.ccorr_tiled_ref(S, T)
    torch.cuda.synchronize()
    n_int8, n_f32 = corr_kernel.path_blocks(reset=True)
    assert n_int8 > 0 and 0 < n_f32 < n_int8
    d = (got.double() - want.double()).abs()
    bound = (28 * 2.0**-24 * tncc.ccorr_tiled_ref(S.abs(), T.abs())
             .double() + 2.0**-23 * want.double().abs())
    assert bool((d <= bound).all())
    assert bool((d[0, :274, :] == 0).all()) and bool(
        (d[0, 320:, :] == 0).all())


def test_corr_kernel_module_imports_without_nvcc():
    """Importing the correlation wrapper, in a fresh process with no nvcc
    reachable, builds and loads nothing."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    code = ("import fastest_image_pattern_matching_tpu_torch.ops.cuda."
            "corr_kernel as c; import fastest_image_pattern_matching_tpu_"
            "torch.ops.ncc; from fastest_image_pattern_matching_tpu_torch."
            "utils.profiling import counter; assert c._LIB is None and "
            "counter('corr.launches') == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("canv_shape,templ_shape", [
    ((1, 40, 50), (5, 6)),      # eligible, but on the CPU
    ((1, 40, 50), (5, 1)),      # too narrow
    ((1, 80, 150), (65, 9)),    # too tall
    ((1, 80, 150), (9, 130)),   # too wide
])
def test_corr_wrapper_rejects_cpu_tensors_and_ineligible_shapes(
        canv_shape, templ_shape):
    """The CUDA entry point raises instead of falling back to the plain
    version, and the eligibility rule is the TPU kernel's: an eligible
    template on the CPU is refused for its device, an ineligible one for
    its shape."""
    h, w = templ_shape
    ok = corr_kernel.eligible(h, w)
    assert ok == (templ_shape == (5, 6))
    with pytest.raises(ValueError, match="CUDA device" if ok else "takes 2"):
        corr_kernel.ccorr_valid_cuda(torch.zeros(canv_shape),
                                     torch.zeros(templ_shape))
