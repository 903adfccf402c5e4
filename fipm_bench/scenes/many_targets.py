"""Frames of many copies of one small part at one angle (tol=0 counting):
a ring washer on a bright background, as the reference tool's Test7
(Src10/Dst10) shows it.

params: "frame_hw", "targets" (copies a frame), "washer" (side in
pixels), "background" (grey), "noise" (the frame's own noise, in [0,
noise), taken off every pixel after the copies are placed, so that no
two copies are alike, as in a photograph), "margin" (pixels kept free at
the edges) and "gap" (the least space between two copies). Each frame
with parts places its copies at positions drawn from the seed; an empty
frame is background alone.
"""

from __future__ import annotations

import numpy as np


def washer(rng, size: int) -> np.ndarray:
    """A dark ring with a bright hole and a notch, on white, with noise."""
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(xx - c, yy - c)
    ring = (r >= 0.22 * size) & (r <= 0.46 * size)
    t = np.full((size, size), 225.0)
    t[ring] = 70.0
    t[(np.abs(yy - c) < 0.05 * size) & (xx > c) & ring] = 150.0
    t -= rng.integers(0, 20, t.shape)
    return np.clip(t, 0, 255).astype(np.uint8)


def make_pool(params: dict, n_frames: int, n_empty: int, rng):
    """-> (template, frames [n, H, W] u8, truths: per frame a list of
    (cx, cy, 0.0))."""
    templ = washer(rng, params["washer"])
    H, W = params["frame_hw"]
    th, tw = templ.shape
    m, gap, n = params["margin"], params["gap"], params["targets"]
    frames = np.empty((n_frames, H, W), np.uint8)
    truths = []
    roles = rng.permutation(n_frames) >= n_empty
    for k in range(n_frames):
        frames[k] = params["background"]
        placed = []
        attempts = 0
        while roles[k] and len(placed) < n and attempts < 100 * n:
            attempts += 1
            y = int(rng.integers(m, H - th - m))
            x = int(rng.integers(m, W - tw - m))
            if any(abs(y - py) < th + gap and abs(x - px) < tw + gap
                   for py, px in placed):
                continue
            frames[k, y:y + th, x:x + tw] = templ
            placed.append((y, x))
        if roles[k] and len(placed) != n:
            raise ValueError(f"placed {len(placed)} of {n} copies")
        noise = rng.integers(0, params["noise"], (H, W), dtype=np.uint8)
        np.subtract(frames[k], np.minimum(frames[k], noise), out=frames[k])
        truths.append([(x + tw / 2.0, y + th / 2.0, 0.0) for y, x in placed])
    return templ, frames, truths
