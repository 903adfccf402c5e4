"""The band decomposition of the correlation kernel's int8 path, on the CPU.

csrc/ccorr_valid.cu builds its band fragments inside the kernel, so the
decomposition is held here through a plain model of the kernel's tiling,
int8_tiling_ref below. It mirrors the kernel's indexing by hand: the
chunking of the window (NC), the band-word indices bf[4s - u + 3] and
bf[4s - u + 5] and the ldmatrix/mma fragment layout, summed exactly in f64.
Nothing ties the model to the CUDA source, so an edit of the kernel's
indexing must be made here too; the kernel itself is held against its
plain version by the `cuda` tests of test_torch_kernels.py and by
chip_smoke.py on the card. The model must equal the plain version of the kernel (ccorr_tiled_ref, an
f64 conv) bit for bit on centred u8 inputs, at Test7's 27x27 template, the
eligibility corners and a ragged edge, and equal the JAX package's Pallas
kernel (int8, interpret mode) on one Test7-shaped case. Inputs are made
with numpy from seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastest_image_pattern_matching_tpu.ops.pallas.corr_kernel import (
    ccorr_tiledband_pallas)

from fastest_image_pattern_matching_tpu_torch.ops import ncc as tncc

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


def chunks_per_tile(w: int) -> int:
    """NC of csrc/ccorr_valid.cu: the 32-column chunks of the window that an
    n8 output tile reads (its taps span j0 .. j0 + w + 6, j0 % 32 <= 24)."""
    return (w + 30) // 32 + 1


def int8_tiling_ref(canvases_c: torch.Tensor, templ_c: torch.Tensor
                    ) -> torch.Tensor:
    """Plain model of the kernel's int8 path, on the CPU: the same sum
    taken the way the kernel's tiles take it, with the kernel's index
    arithmetic, exact in f64 (every partial sum is an integer below 2^53).

    For output column x = 32 C + 8 u + n (n8 tile u of 32-column group C)
    and template row dy, the kernel adds, for s < NC, the product of the
    canvas chunk C + s (32 columns of row y + dy) with a 32 x 8 band
    fragment. The fragment is read the way each lane (g = n, t) of the mma
    holds it: register 0 (k = 4t + i) and register 1 (k = 16 + 4t + i) are
    the band words bf[4s - u + 3] and bf[4s - u + 5], where bf[r] of lane
    (g, t) is the 4 template bytes from f = 8r - 24 + 4t - g of the
    zero-padded row. Returns [B, Ho, Wo] f32 (the exact sum rounded once).
    """
    B, H, W = canvases_c.shape
    h, w = templ_c.shape
    Ho, Wo = H - h + 1, W - w + 1
    nc = chunks_per_tile(w)
    pad = 32
    groups = (Wo + 31) // 32
    S = torch.zeros((B, H, 32 * (groups + nc)), dtype=torch.float64)
    S[:, :, :W] = canvases_c.to(torch.float64)
    tpad = torch.zeros((h, 32 * nc + 64), dtype=torch.float64)
    tpad[:, pad:pad + w] = templ_c.to(torch.float64)
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    r = torch.arange(4 * nc + 2)
    first = 8 * r[:, None] - 24 + 4 * t[None, :] - g[None, :] + pad
    bf = tpad[:, first[:, :, None] + torch.arange(4)]  # [h, R, lane, byte]
    k = torch.arange(32)
    half, t_k, i_k = k // 16, (k % 16) // 4, k % 4
    n = torch.arange(8)
    out = torch.zeros((B, Ho, groups, 32), dtype=torch.float64)
    for s in range(nc):
        # band[dy, k, u, n] for chunk offset s
        reg = (4 * s - torch.arange(4) + 3)[None, :, None] \
            + 2 * half[:, None, None]                       # [k, u, 1]
        ln = (4 * n[None, None, :] + t_k[:, None, None])    # [k, 1, n]
        band = bf[:, reg, ln, i_k[:, None, None]]           # [h, k, u, n]
        band = band.reshape(h, 32, 32)
        for dy in range(h):
            rows = S[:, dy:dy + Ho, 32 * s:32 * (s + groups)]
            out += rows.reshape(B, Ho, groups, 32) @ band[dy]
    return out.reshape(B, Ho, 32 * groups)[:, :, :Wo].to(torch.float32)


def _centred(shape, seed):
    B, H, W, h, w = shape
    rng = np.random.default_rng(seed)
    S = rng.integers(-128, 128, (B, H, W)).astype(np.float32)
    T = rng.integers(-128, 128, (h, w)).astype(np.float32)
    return torch.as_tensor(S), torch.as_tensor(T)


@pytest.mark.parametrize("shape", [
    (1, 200, 300, 27, 27),    # Test7's template
    (1, 140, 260, 64, 129),   # the largest template: h = 64, w = 129
    (2, 40, 190, 13, 2),      # the narrowest: w = 2
    (1, 9, 150, 1, 9),        # one template row: h = 1
    (1, 131, 333, 27, 27),    # ragged: Wo = 307 is no multiple of 32
    (3, 70, 97, 5, 33),       # NC = 3 (w = 33), Ho < 64
])
def test_int8_tiling_bit_equal_to_plain(shape):
    """The kernel's tiling, summed exactly, is the exact correlation:
    bit-equal to the f64 conv on centred u8 values."""
    S, T = _centred(shape, sum(shape))
    got = int8_tiling_ref(S, T)
    want = tncc.ccorr_tiled_ref(S, T)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_int8_tiling_extreme_values():
    """All -128 against all -128 at h = 64, w = 129: the largest sum the
    int8 path can meet (64 * 129 * 128^2 < 2^31), still exact."""
    S = torch.full((1, 70, 140), -128.0)
    T = torch.full((64, 129), -128.0)
    got = int8_tiling_ref(S, T)
    assert float(got.max()) == 64 * 129 * 128.0**2 < 2.0**31
    assert torch.equal(got, tncc.ccorr_tiled_ref(S, T))


@pytest.mark.parametrize("w,nc", [(2, 2), (33, 2), (34, 3), (65, 3),
                                  (66, 4), (97, 4), (98, 5), (129, 5)])
def test_chunks_per_tile(w, nc):
    """NC covers the taps of every n8 tile: a tile at j0 (j0 % 32 <= 24)
    reads columns j0 .. j0 + w + 6, which lie in chunks j0 // 32 ..
    j0 // 32 + NC - 1; one chunk fewer would miss some."""
    assert chunks_per_tile(w) == nc
    last = max((j0 + w + 6) // 32 - j0 // 32 for j0 in range(0, 32, 8))
    assert last == nc - 1


def test_int8_tiling_equals_pallas_interpret():
    """The tiling's sum equals the JAX package's Pallas kernel (int8 path,
    interpret mode) on a Test7-shaped case, bit for bit."""
    S, T = _centred((1, 60, 170, 27, 27), 5)
    want = np.asarray(ccorr_tiledband_pallas(jnp.asarray(S.numpy()),
                                             jnp.asarray(T.numpy()), "int8",
                                             interpret=True))
    got = int8_tiling_ref(S, T).numpy()
    np.testing.assert_array_equal(got, want)
