"""The warp kernel's batched form (a stack of sources and a source index)
on the card, against its plain version. Marked `cuda`: skipped without a
card. Imports nothing of JAX, so that it runs on the card's machine:

    python3 -m pytest --noconftest tests/test_torch_batch_card.py -q
"""

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu_torch.ops import warp as twarp
from fastest_image_pattern_matching_tpu_torch.ops.cuda import warp_kernel
from fastest_image_pattern_matching_tpu_torch.utils import profiling

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [True, False])
def test_warp_kernel_stack_matches_plain_on_card(cuda_device, quantize):
    """The kernel on a stack of three level-1-sized sources, maps reading
    them in mixed order, against the plain version on the card: quantized
    bit-equal, unquantized atol 5e-3 (as the single-source kernel)."""
    rng = np.random.default_rng(9)
    srcs = torch.as_tensor(rng.integers(0, 256, (3, 759, 1006)).astype(
        np.float32), device=cuda_device)
    a = rng.uniform(-np.pi, np.pi, 12)
    maps = torch.as_tensor(np.stack([
        [[np.cos(v), -np.sin(v), 400.0], [np.sin(v), np.cos(v), 300.0]]
        for v in a]).astype(np.float32), device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, 3, 12), dtype=torch.int32,
                          device=cuda_device)
    before = profiling.counter("warp.launches")
    got = warp_kernel.warp_affine_cuda(srcs, maps, (137, 197), 7.0, quantize,
                                       idx)
    want = twarp.warp_affine_batch(srcs, maps, (137, 197), 7.0, quantize,
                                   src_index=idx)
    torch.cuda.synchronize()
    assert profiling.counter("warp.launches") == before + 1
    if quantize:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["range", "negative", "dtype", "length"])
def test_warp_kernel_rejects_bad_source_index(cuda_device, bad):
    srcs = torch.zeros((2, 40, 48), device=cuda_device)
    maps = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]] * 3,
                        device=cuda_device)
    idx = {"range": [0, 1, 2], "negative": [0, -1, 1], "dtype": [0, 1, 1],
           "length": [0, 1]}[bad]
    idx = torch.tensor(idx, dtype=torch.int64 if bad == "dtype"
                       else torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="src_index"):
        warp_kernel.warp_affine_cuda(srcs, maps, (16, 16), 0.0, True, idx)
