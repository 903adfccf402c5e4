"""Image input and output: grayscale conversion of in-memory images,
grayscale file loading and saving (the port of
`fastest_image_pattern_matching_tpu/utils/imageio.py::ensure_gray`,
`load_gray` and `save_gray`), with the grey levels of OpenCV's
cv2.imread(path, IMREAD_GRAYSCALE), which the JAX package calls.

load_gray routes PNG, PNM (P1-P6) and TIFF by their magic bytes to the
readers of utils/codecs/, which need numpy and zlib alone and read 1- to
16-bit samples exactly as OpenCV does; a TIFF feature outside their list
goes to PIL, counted in codecs/tiff.py::PIL_ROUTES. BMP goes through the
C++ codec of the port's native library (native/bmp.py) when it can be
built, and through the numpy twin here when g++ is missing (each such
fallback is counted in native/bmp.py::FALLBACKS); both read and write the
same bytes. JPEG (libjpeg's own Y channel), WebP (cvtColor's weights) and
Sun raster (OpenCV's 14-bit weights) go through PIL, and raise an
ImportError that names PIL where it is missing. save_gray writes BMP,
PNG and PGM without PIL, JPEG (quality 95) and WebP (lossless) through
it, as cv2.imwrite does. The port takes no cv2 (a rule of its tests).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..native import bmp as native_bmp
from .codecs import gray14, orient, png, pnm, tiff
from .profiling import span


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
        # In place in int32 (the weights sum to 2**15, so u8 values cannot
        # overflow), five passes a frame: a camera's frames are converted
        # on its grabber thread, which shares the host with the matcher.
        src = img if img.dtype == np.uint8 else np.round(img)
        v = src[..., 0].astype(np.int32)
        v *= 3735
        for c, w in ((1, 19235), (2, 9798)):
            t = src[..., c].astype(np.int32)
            t *= w
            v += t
        v += 16384
        v >>= 15
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


def _tiff_rgba_gray(im) -> np.ndarray:
    """Colour TIFF as OpenCV reads it: libtiff's TIFFReadRGBAImage
    premultiplies unassociated alpha (ExtraSamples 2) as
    (v * a + 127) // 255 and leaves associated alpha ("RGBa") as stored;
    OpenCV then greys the RGBA with its 14-bit weights (4899, 9617, 1868)
    and a rounding shift (icvCvt_BGRA2Gray_8u_C4C1R)."""
    if im.mode == "RGBa":
        rgb = np.asarray(im)[..., :3].astype(np.int64)
    elif im.mode == "RGBA":
        rgba = np.asarray(im).astype(np.int64)
        rgb = rgba[..., :3]
        if 2 in tuple(im.tag_v2.get(338, ())):
            rgb = (rgb * rgba[..., 3:] + 127) // 255
    else:
        rgb = np.asarray(im.convert("RGB")).astype(np.int64)
    return gray14(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def _pil_gray(path: str, why: str = "") -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise ImportError(f"reading {why or ext + ' images'} needs PIL; "
                          f"without it the port reads BMP, PNG, PNM and "
                          f"baseline TIFF: {path}") from e
    with Image.open(path) as im:
        if im.format == "JPEG":
            # libjpeg hands out its own Y channel, as it does for cv2;
            # imread turns the image as its EXIF Orientation asks.
            im.draft("L", im.size)
            return orient(np.asarray(im.convert("L")),
                          im.getexif().get(274, 1))
        if im.mode.startswith("I;16"):
            return (np.asarray(im) >> 8).astype(np.uint8)
        if im.format == "TIFF" and im.mode in ("RGB", "RGBA", "RGBa",
                                               "RGBX", "P"):
            return _tiff_rgba_gray(im)
        if im.mode not in ("RGB", "RGBA", "P", "PA"):
            return np.asarray(im.convert("L"))
        rgb = np.asarray(im.convert("RGB"))  # alpha dropped, as cv2 does
        if im.format == "SUN":
            # OpenCV's Sun raster decoder greys with its 14-bit weights.
            rgb = rgb.astype(np.int64)
            return gray14(rgb[..., 0], rgb[..., 1], rgb[..., 2])
        # WebP hands OpenCV BGR, which it turns grey with cvtColor.
        return ensure_gray(rgb[..., ::-1])


def load_gray(path: str) -> np.ndarray:
    """Load an image file as 2-D u8 grayscale. PNG, PNM and TIFF (by
    their magic bytes) through utils/codecs/, a TIFF feature outside their
    list through PIL (counted); BMP through the native codec (or its numpy
    twin without g++); anything else through PIL, which raises ImportError
    when it is missing. A malformed, truncated or corrupt file raises
    ValueError."""
    with span("fipm.decode"):
        return _load_gray(path)


def _load_gray(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with span("fipm.decode.read"), open(path, "rb") as f:
        head = f.read(8)
        codec = next((c for c in (png, pnm, tiff) if c.is_magic(head)), None)
        data = head + f.read() if codec is not None else None
    if codec is tiff:
        try:
            return tiff.read_gray(data)
        except tiff.Unsupported as e:
            tiff.count_pil_route()
            return _pil_gray(path, f"a TIFF with {e}")
    if codec is not None:
        return codec.read_gray(data)
    if path.lower().endswith(".bmp"):
        if native_bmp.available():
            return native_bmp.load_gray(path)
        return _bmp_gray(path)
    return _pil_gray(path)


def _bmp_gray_bytes(img: np.ndarray) -> bytes:
    """A 2-D u8 image as an uncompressed 8-bit BMP with a grey palette,
    rows bottom-up and padded to 4 bytes: the native codec's bytes (no
    pixels-per-metre)."""
    h, w = img.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = img[::-1]
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    data_off = 14 + 40 + palette.nbytes
    size = data_off + rows.nbytes
    header = (b"BM" + size.to_bytes(4, "little") + bytes(4)
              + data_off.to_bytes(4, "little"))
    info = b"".join(v.to_bytes(n, "little", signed=True) for v, n in (
        (40, 4), (w, 4), (h, 4), (1, 2), (8, 2), (0, 4), (rows.nbytes, 4),
        (0, 4), (0, 4), (256, 4), (0, 4)))
    return header + info + palette.tobytes() + rows.tobytes()


def save_gray(path: str, img) -> None:
    """Save a 2-D image as u8 grayscale (float input rounded and clipped
    to [0, 255]). BMP through the native codec (or its numpy twin without
    g++), 8-bit grey PNG and binary PGM in numpy and zlib; other formats
    through PIL (JPEG at quality 95, WebP lossless, as cv2.imwrite writes
    them), which raises ImportError when it is missing."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"save_gray takes a 2-D image, got shape "
                         f"{img.shape}")
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp" and native_bmp.available():
        native_bmp.save_gray(path, img)
        return
    encode = {".bmp": _bmp_gray_bytes, ".png": png.encode_gray8,
              ".pgm": pnm.encode_pgm}.get(ext)
    if encode is not None:
        with open(path, "wb") as f:
            f.write(encode(img))
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"writing {ext or '(no extension)'} images needs "
                          f"PIL; without it the port writes BMP, PNG and "
                          f"PGM: {path}") from e
    # cv2.imwrite's defaults: JPEG quality 95, lossless WebP.
    options = {".jpg": {"quality": 95}, ".jpeg": {"quality": 95},
               ".webp": {"lossless": True}}.get(ext, {})
    Image.fromarray(img).save(path, **options)
