"""The peak kernel (csrc/peaks.cu, ops/cuda/peaks_kernel.py).

On the CPU: the wrapper module imports without nvcc, CPU tensors take the
plain loop and launch nothing, the wrapper raises on what the kernel does
not take, the tile plan keeps a rectangle within 2 x 2 tiles, and the
deployment packs carry the new library. Tests marked `cuda` hold the
kernel against the plain loop (run on the CPU) bit for bit on the card,
in both of its forms, and skip without one.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu_torch import aot
from fastest_image_pattern_matching_tpu_torch.ops import peaks
from fastest_image_pattern_matching_tpu_torch.ops.cuda import (build,
                                                           peaks_kernel)
from fastest_image_pattern_matching_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The flagship's top layer (41 maps of 60x59, a 12x9 template, overlap
# 0.1, k = 8) and Test7's (one 1798x1798 map, a 27x27 template, overlap
# 0.5, k = 105).
FLAGSHIP = ((41, 60, 59), 8, (12, 9), 0.1)
WASHERS = ((1, 1798, 1798), 105, (27, 27), 0.5)


def _rect(templ_wh, overlap):
    tw, th = templ_wh
    return int(2 * tw * (1 - overlap)), int(2 * th * (1 - overlap))


def _scores(shape, seed, quantized=False):
    """Score-like maps in [-1, 1] with planted peaks; quantized to
    multiples of 1/8 (ties and plateaus everywhere) when asked."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.0, 0.6, shape)
    A, H, W = shape
    for a in range(A):
        for y, x in zip(rng.integers(0, H, 40), rng.integers(0, W, 40)):
            s[a, y, x] = rng.uniform(0.7, 1.0)
    if quantized:
        s = np.round(s * 8) / 8
    return torch.as_tensor(s.astype(np.float32))


def test_peaks_kernel_module_imports_without_nvcc():
    """Importing the wrapper and ops/peaks.py, in a fresh process with no
    nvcc reachable, builds and loads nothing."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    code = ("import fastest_image_pattern_matching_tpu_torch.ops.cuda."
            "peaks_kernel as p; import fastest_image_pattern_matching_tpu_"
            "torch.ops.peaks; from fastest_image_pattern_matching_tpu_torch."
            "utils.profiling import counter; assert p._LIB is None and "
            "counter('peaks.launches') == 0 and counter('peaks.tiled') == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("shape,k,templ_wh,overlap", [
    ((3, 30, 41), 8, (12, 9), 0.1),
    ((1, 140, 150), 20, (27, 27), 0.5),   # the size of the tile form
])
def test_cpu_tensors_take_plain_loop(shape, k, templ_wh, overlap):
    """extract_peaks on CPU tensors is the plain loop, with its round
    spans' path, and counts no launch."""
    scores = _scores(shape, 3)
    before = (profiling.counter("peaks.launches"),
              profiling.counter("peaks.tiled"))
    got = peaks.extract_peaks(scores, k, templ_wh, overlap)
    sw, sh = _rect(templ_wh, overlap)
    tw, th = templ_wh
    want = peaks.extract_peaks_ref(scores, k, sw, sh,
                                   float(np.float32(tw * (1 - overlap))),
                                   float(np.float32(th * (1 - overlap))))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[1].shape == (shape[0], k, 2)
    assert (profiling.counter("peaks.launches"),
            profiling.counter("peaks.tiled")) == before


@pytest.mark.parametrize("scores,err,match", [
    (torch.zeros((4, 5, 6)), ValueError, "CUDA tensor"),
    (torch.zeros((4, 5, 6), dtype=torch.float64), TypeError, "float32"),
    (torch.zeros((4, 6, 5)).transpose(1, 2), ValueError, "contiguous"),
    (torch.zeros((5, 6)), ValueError, r"\[A, Hs, Ws\]"),
])
def test_peaks_wrapper_rejects(scores, err, match):
    """The CUDA entry point raises instead of falling back to the plain
    loop: CPU tensors, other dtypes, non-contiguous and non-3-d input."""
    with pytest.raises(err, match=match):
        peaks_kernel.extract_peaks_cuda(scores, 8, 3, 3, 1.5, 1.5)


@pytest.mark.parametrize("hw,rect", [((60, 59), (21, 16)),
                                     ((128, 128), (27, 27)),
                                     ((128, 129), (27, 27)),
                                     ((1798, 1798), (27, 27)),
                                     ((1798, 1798), (54, 54)),
                                     ((1798, 1798), (0, 0)),
                                     ((300, 5000), (200, 7)),
                                     ((9000, 9000), (27, 27))])
def test_tile_plan(hw, rect):
    """Maps of up to SMALL_MAX values take the small form; a larger map's
    tiles are at least the rectangle's size (so a rectangle touches at
    most 2 x 2 tiles) and at most MAX_TILES (the cache's 32 KB of shared
    memory)."""
    (H, W), (sw, sh) = hw, rect
    tiles = peaks_kernel.plan(H, W, sw, sh)
    if H * W <= peaks_kernel.SMALL_MAX:
        assert tiles is None
        return
    th, tw = tiles
    assert th >= max(sh, peaks_kernel.TILE) and tw >= max(
        sw, peaks_kernel.TILE)
    assert -(-H // th) * -(-W // tw) <= peaks_kernel.MAX_TILES
    if hw == (1798, 1798) and rect == (27, 27):
        assert tiles == (32, 32)


def test_packs_carry_peaks_library():
    """The deployment packs bundle, install and load the peak kernel's
    library with the other two, so a pack never runs nvcc for it."""
    assert peaks_kernel.SOURCE in aot._CUDA_SOURCES
    assert os.path.isfile(os.path.join(build.CSRC_DIR, peaks_kernel.SOURCE))
    assert build.library_identity(peaks_kernel.SOURCE)["file"].startswith(
        "libpeaks_")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _hold(scores, k, templ_wh, overlap, dev):
    """The kernel (through extract_peaks) against the plain loop on the
    CPU, bit for bit; returns (launches, tile-form calls) it counted."""
    before = (profiling.counter("peaks.launches"),
              profiling.counter("peaks.tiled"))
    got = peaks.extract_peaks(scores.to(dev), k, templ_wh, overlap)
    torch.cuda.synchronize()
    counted = (profiling.counter("peaks.launches") - before[0],
               profiling.counter("peaks.tiled") - before[1])
    want = peaks.extract_peaks(scores, k, templ_wh, overlap)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    return counted


@pytest.mark.cuda
@pytest.mark.parametrize("case,quantized", [(FLAGSHIP, False),
                                            (FLAGSHIP, True),
                                            (WASHERS, False),
                                            (WASHERS, True)])
def test_peaks_kernel_main_path_shapes_on_card(cuda_device, case, quantized):
    """The flagship's top layer takes the small form (one launch) and
    Test7's map the tile form (two launches, one tiled call), each equal
    to the plain loop, with plain scores and with scores quantized to
    multiples of 1/8."""
    shape, k, templ_wh, overlap = case
    counted = _hold(_scores(shape, 5, quantized), k, templ_wh, overlap,
                    cuda_device)
    assert counted == ((1, 0) if case is FLAGSHIP else (2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,quantized", [((2, 700, 650), 40, False),
                                               ((3, 300, 420), 30, True)])
def test_peaks_kernel_several_large_maps_on_card(cuda_device, shape, k,
                                                 quantized):
    """Several large maps in one call, one block each in the round
    launch."""
    assert _hold(_scores(shape, 6, quantized), k, (27, 27), 0.5,
                 cuda_device) == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 60, 59), (1, 400, 380)])
@pytest.mark.parametrize("fill", ["nan", "all_minus_one", "borders"])
def test_peaks_kernel_special_maps_on_card(cuda_device, shape, fill):
    """NaNs (greater than any number, the first one first), an all -1 map
    (every round the same first index after the first fill) and peaks on
    the four borders and corners, in both forms."""
    scores = _scores(shape, 7)
    A, H, W = shape
    if fill == "nan":
        for y, x in ((0, 0), (H // 2, W // 3), (H - 1, W - 1), (5, W - 2)):
            scores[:, y, x] = float("nan")
    elif fill == "all_minus_one":
        scores = torch.full(shape, -1.0)
    else:
        scores *= 0.1
        for v, (y, x) in enumerate(((0, W // 2), (H - 1, W // 3),
                                    (H // 2, 0), (H // 3, W - 1), (0, 0),
                                    (H - 1, W - 1), (0, W - 1),
                                    (H - 1, 0))):
            scores[:, y, x] = 2.0 - 0.1 * v
    _hold(scores, 12, (27, 27) if H > 100 else (12, 9), 0.3, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 60, 59), (1, 500, 520)])
@pytest.mark.parametrize("overlap", [0.0, 0.9, 0.99])
def test_peaks_kernel_overlaps_on_card(cuda_device, shape, overlap):
    """Overlaps 0.0 (the largest rectangle) and 0.9, and 0.99, whose
    rectangle is empty (sw == sh == 0): every round then returns the same
    peak, as the plain loop does."""
    templ_wh = (12, 9) if shape[1] < 100 else (27, 27)
    if overlap == 0.99:
        assert _rect(templ_wh, overlap) == (0, 0)
    _hold(_scores(shape, 8, True), 10, templ_wh, overlap, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,counted", [((128, 128), (1, 0)),
                                        ((128, 129), (2, 1)),
                                        ((127, 129), (1, 0)),
                                        ((129, 128), (2, 1))])
def test_peaks_kernel_switch_on_card(cuda_device, hw, counted):
    """Maps just below and just above SMALL_MAX values take the small and
    the tile form, with the same results as the plain loop."""
    assert _hold(_scores((3,) + hw, 9, True), 25, (27, 27), 0.5,
                 cuda_device) == counted
