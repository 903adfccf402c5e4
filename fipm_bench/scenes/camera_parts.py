"""A colour camera's frames of a tray of parts: the grey frames of
rotated_parts.py, each turned into the BGR24 buffer a camera delivers
(dvpSetTargetFormat BGR24, src/CameraPreviewDialog.cpp:386-428).

params: those of rotated_parts.py, plus "cast" (each channel's offset
from the grey is drawn once a pool from [-cast, cast]) and
"sensor_noise" (each sample of each channel moves by a draw from
[-sensor_noise, sensor_noise]), the sums clipped to [0, 255]; so the
BT.601 grey of a frame is near the drawn grey and is no single channel.
"""

from __future__ import annotations

import numpy as np

from fipm_bench.scenes import rotated_parts


def make_pool(params: dict, n_frames: int, n_empty: int, rng):
    """-> (template u8 [h, w], frames u8 [n, H, W, 3] in BGR order,
    truths: per frame a list of (cx, cy, angle deg))."""
    templ, grey, truths = rotated_parts.make_pool(params, n_frames, n_empty,
                                                  rng)
    cast = rng.integers(-params["cast"], params["cast"] + 1, 3)
    noise = params["sensor_noise"]
    frames = np.empty(grey.shape + (3,), np.uint8)
    for k in range(n_frames):
        wobble = rng.integers(-noise, noise + 1, frames.shape[1:],
                              dtype=np.int16)
        frames[k] = np.clip(grey[k][..., None].astype(np.int16) + cast
                            + wobble, 0, 255)
    return templ, frames, truths
