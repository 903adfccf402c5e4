"""Gaussian image pyramid with cv::pyrDown parity.

cv::pyrDown is a 5-tap [1,4,6,4,1]/16 separable blur with
BORDER_REFLECT_101, a stride-2 subsample to ((n+1)/2) and, for u8 input,
the fixed-point rounding (sum + 128) >> 8 of the integer-weighted 2D sum.

Here one level is a single 5x5 stride-2 f32 convolution. The integer sum is
at most 255 * 256 = 65280 < 2^24, so every partial sum is exact in f32 in
any order, provided TF32 is off (the package turns it off on import).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32)
_KERNEL_2D = np.outer(_KERNEL_1D, _KERNEL_1D)  # sums to 256


def _reflect101_index(n: int, device) -> torch.Tensor:
    """Source index of each of the n + 4 padded positions under
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcb); numpy's "reflect" pad,
    which also covers n < 3 by repeated reflection."""
    return torch.as_tensor(np.pad(np.arange(n), 2, mode="reflect"),
                           device=device)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One cv::pyrDown step on a u8-valued f32 image [h, w] or stack of
    images [N, h, w] (one convolution for the stack); returns u8-valued
    f32 of shape [..., (h+1)//2, (w+1)//2]."""
    h, w = img.shape[-2:]
    x = img.to(torch.float32)
    x = x.index_select(-2, _reflect101_index(h, x.device))
    x = x.index_select(-1, _reflect101_index(w, x.device))
    k = torch.as_tensor(_KERNEL_2D, device=x.device)[None, None]
    out = F.conv2d(x.reshape(-1, 1, h + 4, w + 4), k, stride=2)
    out = out.reshape(*img.shape[:-2], *out.shape[-2:])
    return torch.floor((out + 128.0) / 256.0)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """cv::buildPyramid of an image [H, W] or stack [N, H, W]: [level0,
    ..., level_levels] as u8-valued f32."""
    out = [img.to(torch.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return out
