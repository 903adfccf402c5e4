"""The plain reference of the camera stream: a BGR24 frame to grey by
OpenCV's documented fixed-point BT.601 conversion (cv::cvtColor with
COLOR_BGR2GRAY on 8-bit input: Y = (3735 B + 19235 G + 9798 R + 2^14)
>> 15, the weights 0.114, 0.587 and 0.299 in 15 bits), written here in
NumPy, then the plain reference matcher (matcher.py) on that grey. It
imports nothing of the port.

`answer` is the entry the harness calls, by the name `camera` that a
configuration gives as its `reference`.
"""

from __future__ import annotations

import numpy as np

from fipm_bench.reference import matcher

# cv::cvtColor's BGR2GRAY weights for 8-bit data, 15 fractional bits.
B_Y, G_Y, R_Y, SHIFT = 3735, 19235, 9798, 15


def grey(frame_bgr: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 BGR -> [H, W] u8 BT.601 luma, rounded half up."""
    f = np.asarray(frame_bgr)
    if f.dtype != np.uint8 or f.ndim != 3 or f.shape[-1] != 3:
        raise ValueError(f"expected an [H, W, 3] uint8 BGR frame, got "
                         f"{f.dtype} {f.shape}")
    b, g, r = (f[..., c].astype(np.int32) for c in range(3))
    y = (B_Y * b + G_Y * g + R_Y * r + (1 << (SHIFT - 1))) >> SHIFT
    return y.astype(np.uint8)


def answer(frame_bgr: np.ndarray, templ_u8: np.ndarray, config: dict,
           device, work=None, score_dtype="float32") -> np.ndarray:
    """The reference's match list for one camera frame: the grey, then
    matcher.answer (score_dtype as there; a control passes a lower
    one)."""
    return matcher.answer(grey(frame_bgr), templ_u8, config, device,
                          work=work, score_dtype=score_dtype)
