"""Frames that each hold one textured part (the ORB configurations): a
template of 8x8 blocks of uniform noise, blurred, with discs of random
grey on it, turned and shifted into a frame of background noise.

params: "frame_hw", "noise" (background grey in [0, noise)), "template"
({"hw", "block" (side of the noise blocks), "blur" (Gaussian sigma),
"disc_area" (one disc per this many pixels, 40 at least), "disc_r" ([least,
most) radius)}) and "poses" ([cx, cy, angle deg]): the k-th frame with a
part holds it at poses[k % len(poses)], pasted by draw.paste_rotated; an
empty frame is background alone. The seed draws the template, the noise
and the frames' order, so every seed gives the same sizes and poses in
another order.
"""

from __future__ import annotations

import math

import numpy as np

from fipm_bench.scenes import draw


def template(spec: dict, rng) -> np.ndarray:
    """The textured part, u8 [h, w]."""
    from scipy import ndimage
    h, w = spec["hw"]
    b = spec["block"]
    blocks = rng.integers(0, 255, size=(h // b + 1, w // b + 1))
    img = np.repeat(np.repeat(blocks, b, 0), b, 1)[:h, :w]
    img = np.clip(np.rint(ndimage.gaussian_filter(img.astype(np.float64),
                                                  spec["blur"])), 0, 255)
    img = img.astype(np.uint8)
    lo, hi = spec["disc_r"]
    for _ in range(max(40, h * w // spec["disc_area"])):
        x, y = int(rng.integers(10, w - 10)), int(rng.integers(10, h - 10))
        r, val = int(rng.integers(lo, hi)), int(rng.integers(0, 255))
        y0, x0 = max(y - r, 0), max(x - r, 0)
        draw._disc(img[y0:y + r + 1, x0:x + r + 1], x - x0, y - y0, r, val)
    return img


def corners(templ_hw, centre, angle_deg) -> np.ndarray:
    """Where draw.paste_rotated puts the template's corners (0, 0), (w, 0),
    (w, h), (0, h) (ORBResult.corners' order), from the centre it returns:
    its map turns template offsets from (w/2, h/2) by [[c, s], [-s, c]]."""
    h, w = templ_hw
    a = math.radians(angle_deg)
    lin = np.array([[math.cos(a), math.sin(a)],
                    [-math.sin(a), math.cos(a)]])
    tc = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    return (tc - [w / 2.0, h / 2.0]) @ lin.T + np.asarray(centre)


def make_pool(params: dict, n_frames: int, n_empty: int, rng):
    """-> (template u8 [h, w], frames u8 [n, H, W], truths: per frame the
    part's true corners [4, 2], or None for an empty frame)."""
    templ = template(params["template"], rng)
    H, W = params["frame_hw"]
    frames = np.empty((n_frames, H, W), np.uint8)
    truths = []
    # Frame k holds the pose of rank[k], or no part when rank[k] < n_empty.
    rank = rng.permutation(n_frames)
    poses = params["poses"]
    for k in range(n_frames):
        frames[k] = rng.integers(0, params["noise"], (H, W), dtype=np.uint8)
        if rank[k] < n_empty:
            truths.append(None)
            continue
        cx, cy, ang = poses[(rank[k] - n_empty) % len(poses)]
        centre = draw.paste_rotated(frames[k], templ, cx, cy, ang)
        truths.append(corners(templ.shape, centre, ang))
    return templ, frames, truths
