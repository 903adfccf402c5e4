"""Grayscale conversion of in-memory images (the port of
`fastest_image_pattern_matching_tpu/utils/imageio.py::ensure_gray`).

File loading stays with the JAX package's CLI for now; the port takes
arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def ensure_gray(img, channel_axis_only: bool = False):
    """Collapse a trailing channel axis of an image (or batch).

    Size-1 axes are squeezed; 3/4-channel input (BGR order) goes through
    cv::cvtColor(BGR2GRAY)'s 15-bit fixed-point BT.601 luma, after rounding
    float input to the u8-valued contract, so numpy and torch callers get
    identical gray values. 2D input is returned untouched.
    `channel_axis_only=True` raises instead of converting."""
    if img.ndim < 2:
        raise ValueError(f"expected an image array, got ndim={img.ndim}")
    if img.ndim == 2:
        return img
    ch = img.shape[-1]
    if ch == 1:
        return img[..., 0]
    if ch not in (3, 4):
        raise ValueError(f"expected 1/3/4 channels, got trailing axis {ch}")
    if channel_axis_only:
        raise ValueError("grayscale input required (H, W); convert color "
                         "frames with utils.imageio.ensure_gray first")
    img = img[..., :3]
    if isinstance(img, np.ndarray):
        b = np.round(img[..., 0]).astype(np.int64)
        g = np.round(img[..., 1]).astype(np.int64)
        r = np.round(img[..., 2]).astype(np.int64)
        v = (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15
        return v.astype(np.uint8 if img.dtype == np.uint8 else img.dtype)
    ii = torch.round(img.to(torch.float32)).to(torch.int64)
    v = (ii[..., 0] * 3735 + ii[..., 1] * 19235 + ii[..., 2] * 9798
         + 16384) >> 15
    return v.to(torch.float32)
