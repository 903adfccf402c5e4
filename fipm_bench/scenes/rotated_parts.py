"""Frames that hold a learned part at a few poses, the whole pose set
turned about the frame's centre by an angle drawn for each frame.

params: "frame_hw", "noise" (background grey in [0, noise)), "template"
(a draw.template spec), "poses" ([cx, cy, angle deg] in the frame) and
"turns" (deg): the k-th frame with parts has the poses turned by
turns[k % len(turns)], on a background of its own; an empty frame (a tray
with no part) is background alone. The seed draws the noise and the
frames' order, so every seed gives the same sizes, poses and work, in
another order.
"""

from __future__ import annotations

import math

import numpy as np

from fipm_bench.scenes import draw


def make_pool(params: dict, n_frames: int, n_empty: int, rng):
    """-> (template u8 [h, w], frames u8 [n, H, W], truths: per frame a
    list of (cx, cy, angle deg) as the matcher reports them)."""
    templ = draw.template(params["template"], rng)
    H, W = params["frame_hw"]
    oy, ox = (H - 1) / 2.0, (W - 1) / 2.0
    frames = np.empty((n_frames, H, W), np.uint8)
    truths = []
    # Frame k holds the turn of rank[k], or no part when rank[k] < n_empty.
    rank = rng.permutation(n_frames)
    turns = params["turns"]
    for k in range(n_frames):
        frames[k] = rng.integers(0, params["noise"], (H, W), dtype=np.uint8)
        if rank[k] < n_empty:
            truths.append([])
            continue
        turn = float(turns[(rank[k] - n_empty) % len(turns)])
        ca, sa = math.cos(math.radians(turn)), math.sin(math.radians(turn))
        placed = []
        for cx, cy, a in params["poses"]:
            px = ox + (cx - ox) * ca + (cy - oy) * sa
            py = oy - (cx - ox) * sa + (cy - oy) * ca
            ang = (a + turn + 180.0) % 360.0 - 180.0
            placed.append((*draw.paste_rotated(frames[k], templ, px, py, ang),
                           ang))
        truths.append(placed)
    return templ, frames, truths
