"""The port's load_gray on colour files against the JAX package's, which
decodes them with cv2.imread(IMREAD_GRAYSCALE), and its BMP save_gray
against the JAX package's bytes.

The port takes no cv2: JPEG grey comes from libjpeg's Y channel (PIL's
draft mode), PNG and other colour sources from libpng's rgb-to-gray
weights, colour TIFF from libtiff's RGBA image (unassociated alpha
premultiplied) and OpenCV's 14-bit luma, as OpenCV's decoders give them. The JAX package falls back to
PIL's convert("L") when cv2 does not import, so the comparison needs cv2
and skips without it.
"""

import numpy as np
import pytest
import torch

from fastest_image_pattern_matching_tpu.utils import imageio as jio

from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio
from fastest_image_pattern_matching_tpu_torch.utils.codecs import png

from test_torch_multi_template import _write_bmp

# One intra-op thread: the tier-1 run keeps every core busy (six xdist
# workers), and there torch's spinning OpenMP pool made port calls
# about 50x slower (one overflow case: 466 s, 10 s on one thread).
torch.set_num_threads(1)

KINDS = ["colour_png", "rgba_png", "palette_png", "jpeg_q95", "bgr24_bmp",
         "grey_png", "grey_alpha_png", "webp", "rgb_tiff", "rgba_tiff",
         "grey_tiff", "grey_alpha_tiff", "palette_tiff", "rgba_lzw_tiff"]


def _write(path_stem, kind, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (96, 128, 3), np.uint8)
    if kind == "colour_png":
        path = path_stem + ".png"
        Image.fromarray(rgb).save(path)
    elif kind == "rgba_png":
        path = path_stem + ".png"
        alpha = rng.integers(0, 256, (96, 128, 1), np.uint8)
        Image.fromarray(np.concatenate([rgb, alpha], 2)).save(path)
    elif kind == "palette_png":
        path = path_stem + ".png"
        Image.fromarray(rgb).quantize(200).save(path)
    elif kind == "jpeg_q95":
        path = path_stem + ".jpg"
        Image.fromarray(rgb).save(path, quality=95)
    elif kind == "bgr24_bmp":
        path = path_stem + ".bmp"
        _write_bmp(path, rgb, 24, False)
    elif kind == "grey_png":
        path = path_stem + ".png"
        Image.fromarray(rgb[..., 0]).save(path)
    elif kind == "grey_alpha_png":
        path = path_stem + ".png"
        Image.fromarray(rgb[..., 0]).convert("LA").save(path)
    elif kind == "webp":
        path = path_stem + ".webp"
        Image.fromarray(rgb).save(path, lossless=True)
    else:
        path = path_stem + ".tif"
        alpha = rng.integers(0, 256, (96, 128), np.uint8)
        img = {"rgb_tiff": lambda: Image.fromarray(rgb),
               "rgba_tiff": lambda: Image.fromarray(
                   np.concatenate([rgb, alpha[..., None]], 2)),
               "rgba_lzw_tiff": lambda: Image.fromarray(
                   np.concatenate([rgb, alpha[..., None]], 2)),
               "grey_tiff": lambda: Image.fromarray(rgb[..., 0]),
               "grey_alpha_tiff": lambda: Image.fromarray(
                   np.stack([rgb[..., 0], alpha], -1), "LA"),
               "palette_tiff": lambda: Image.fromarray(rgb).quantize(200),
               }[kind]()
        img.save(path, **({"compression": "tiff_lzw"}
                          if kind == "rgba_lzw_tiff" else {}))
    return path


@pytest.mark.parametrize("kind", KINDS)
def test_load_gray_colour_vs_jax(tmp_path, kind):
    """0 differing pixels on every kind of file (the PIL defaults missed
    by 1 grey level on ~50% of colour-PNG pixels, by up to 17 on ~1% of
    JPEG pixels, by 1 on ~0.3% of RGB TIFF pixels and by up to 242 on
    ~99% of RGBA TIFF pixels)."""
    pytest.importorskip("cv2", reason="the JAX package decodes with cv2 "
                        "only where cv2 imports; without it there is no "
                        "cv2 result to hold the port against")
    path = _write(str(tmp_path / "img"), kind, KINDS.index(kind))
    got = tio.load_gray(path)
    want = jio.load_gray(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (96, 128)
    np.testing.assert_array_equal(got, want)


def test_png_rgb_to_gray_passes_grey_through():
    v = np.arange(256, dtype=np.uint8)
    rgb = np.stack([v, v, v], -1)
    np.testing.assert_array_equal(png._png_rgb_to_gray(rgb), v)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_save_gray_bmp_bytes_equal_jax(tmp_path, dtype):
    img = np.random.default_rng(8).integers(0, 256, (31, 45)).astype(dtype)
    if dtype == np.float32:
        img += 0.4
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    tio.save_gray(a, img)
    jio.save_gray(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
