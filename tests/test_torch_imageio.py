"""The port's load_gray on colour files against the JAX package's, which
decodes them with cv2.imread(IMREAD_GRAYSCALE), and its BMP save_gray
against the JAX package's bytes.

The port takes no cv2: JPEG grey comes from libjpeg's Y channel (PIL's
draft mode), PNG and other colour sources from libpng's rgb-to-gray
weights, as OpenCV's decoders give them. The JAX package falls back to
PIL's convert("L") when cv2 does not import, so the comparison needs cv2
and skips without it.
"""

import numpy as np
import pytest

from fastest_image_pattern_matching_tpu.utils import imageio as jio

from fastest_image_pattern_matching_tpu_torch.utils import imageio as tio

from test_torch_multi_template import _write_bmp

KINDS = ["colour_png", "rgba_png", "palette_png", "jpeg_q95", "bgr24_bmp",
         "grey_png", "grey_alpha_png", "webp"]


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
    else:
        path = path_stem + ".webp"
        Image.fromarray(rgb).save(path, lossless=True)
    return path


@pytest.mark.parametrize("kind", KINDS)
def test_load_gray_colour_vs_jax(tmp_path, kind):
    """0 differing pixels on every kind of file (the PIL defaults missed
    by 1 grey level on ~50% of colour-PNG pixels and by up to 17 on ~1% of
    JPEG pixels)."""
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
    np.testing.assert_array_equal(tio._png_rgb_to_gray(rgb), v)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_save_gray_bmp_bytes_equal_jax(tmp_path, dtype):
    img = np.random.default_rng(8).integers(0, 256, (31, 45)).astype(dtype)
    if dtype == np.float32:
        img += 0.4
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    tio.save_gray(a, img)
    jio.save_gray(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
