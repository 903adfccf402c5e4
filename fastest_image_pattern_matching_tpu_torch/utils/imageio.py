"""Image input: grayscale conversion of in-memory images and grayscale
file loading (the port of
`fastest_image_pattern_matching_tpu/utils/imageio.py::ensure_gray` and
`load_gray`).

The JAX package decodes BMP with the C++ codec of its native library and
other formats with cv2 or PIL. The port reads BMP in numpy (8-bit
palettised, 24- and 32-bit, bottom-up and top-down, uncompressed: what
that codec reads, with its BT.601 luma and rounding), so glyph sets in
BMP load with no image library; other formats need PIL. The port takes
no cv2 (a rule of its tests), and the card's machine has neither.
"""

from __future__ import annotations

import os

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


def _bmp_gray(path: str) -> np.ndarray:
    """Decode an uncompressed BMP to 2-D u8 gray: palette entries and
    pixels through round(0.299 R + 0.587 G + 0.114 B)."""
    with open(path, "rb") as f:
        data = f.read()

    def u32(off):
        return int.from_bytes(data[off:off + 4], "little", signed=True)

    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError(f"cannot decode BMP: {path}")
    data_off, hdr_size, width, height = u32(10), u32(14), u32(18), u32(22)
    bpp = int.from_bytes(data[28:30], "little")
    if width <= 0 or u32(30) != 0 or bpp not in (8, 24, 32):
        raise ValueError(f"unsupported BMP (only uncompressed 8/24/32-bit): "
                         f"{path}")
    h = abs(height)
    stride = (width * bpp // 8 + 3) & ~3
    if data_off + stride * h > len(data):
        raise ValueError(f"truncated BMP: {path}")
    rows = np.frombuffer(data, np.uint8, stride * h, data_off).reshape(
        h, stride)

    def luma(bgr):
        b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
        return np.floor(0.299 * r + 0.587 * g + 0.114 * b + 0.5).astype(
            np.uint8)

    if bpp == 8:
        n_colors = u32(46)
        if n_colors <= 0 or n_colors > 256:
            n_colors = 256
        pal_off = 14 + hdr_size
        pal = np.zeros(256, np.uint8)
        pal[:n_colors] = luma(np.frombuffer(
            data, np.uint8, 4 * n_colors, pal_off).reshape(n_colors, 4))
        img = pal[rows[:, :width]]
    else:
        img = luma(rows[:, :width * bpp // 8].reshape(h, width, bpp // 8))
    return np.ascontiguousarray(img[::-1] if height > 0 else img)


def load_gray(path: str) -> np.ndarray:
    """Load an image file as 2-D u8 grayscale. BMP is decoded here; other
    formats through PIL, which raises ImportError when it is missing."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.lower().endswith(".bmp"):
        return _bmp_gray(path)
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise ImportError(f"reading {ext} images needs PIL; the port reads "
                          f"only BMP without it: {path}") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))
