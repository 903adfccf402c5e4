"""Host-side planning geometry (numpy, float64).

These functions run at trace/plan time — they only depend on static image
shapes and the angle schedule, never on pixel data, so they stay in numpy
and their results are baked into the compiled TPU program as static shapes
or passed as small constant arrays.

Reference semantics:
  - rotate_pt       <- ptRotatePt2f          (MatchTool/MatchToolDlg.cpp:1469-1480)
  - best_rotation_size <- GetBestRotationSize (MatchTool/MatchToolDlg.cpp:1401-1468)
  - angle_schedule  <- angle list construction (MatchTool/MatchToolDlg.cpp:801-828)
  - top_layer       <- GetTopLayer           (MatchTool/MatchToolDlg.cpp:493-504)
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..config import D2R, R2D, VISION_TOLERANCE


def rotate_pt(pt, org, angle_rad):
    """Rotate `pt` about `org` by `angle_rad`.

    In image coordinates (y down) this maps
        x' = ox + (x-ox)*cos(a) + (y-oy)*sin(a)
        y' = oy - (x-ox)*sin(a) + (y-oy)*cos(a)
    which is exactly the reference's ptRotatePt2f (it flips to y-up, rotates
    CCW, flips back; MatchToolDlg.cpp:1469-1480) and also exactly what
    cv::getRotationMatrix2D(org, a*R2D, 1) applies to a point.

    Works on scalars or numpy arrays (broadcasting over leading dims of pt).
    """
    pt = np.asarray(pt, dtype=np.float64)
    org = np.asarray(org, dtype=np.float64)
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    dx = pt[..., 0] - org[..., 0]
    dy = pt[..., 1] - org[..., 1]
    x = org[..., 0] + dx * c + dy * s
    y = org[..., 1] - dx * s + dy * c
    return np.stack([x, y], axis=-1)


def rotation_matrix(center: Tuple[float, float], angle_deg: float) -> np.ndarray:
    """cv::getRotationMatrix2D(center, angle_deg, 1) — forward 2x3 affine."""
    a = angle_deg * D2R
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array(
        [[alpha, beta, (1 - alpha) * cx - beta * cy],
         [-beta, alpha, beta * cx + (1 - alpha) * cy]], dtype=np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine matrix (what warpAffine does internally for the
    default, non-WARP_INVERSE_MAP flags)."""
    a, b, tx = m[0]
    c, d, ty = m[1]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return np.array([[ia, ib, itx], [ic, id_, ity]], dtype=np.float64)


def top_layer(templ_hw: Tuple[int, int], min_reduce_area: int) -> int:
    """Number of pyramid levels above level 0 (GetTopLayer,
    MatchToolDlg.cpp:493-504). Note the reference squares
    int(sqrt(min_reduce_area)) first (call site :458)."""
    min_len = int(math.sqrt(float(min_reduce_area)))
    min_area = min_len * min_len
    area = templ_hw[0] * templ_hw[1]
    layer = 0
    while area > min_area:
        area //= 4
        layer += 1
    return layer


def angle_step(templ_hw: Tuple[int, int]) -> float:
    """Per-level angle step in degrees: atan(2/max(W,H))*R2D
    (MatchToolDlg.cpp:801, :959)."""
    return math.atan(2.0 / max(templ_hw[0], templ_hw[1])) * R2D


def angle_schedule(
    templ_hw: Tuple[int, int],
    tolerance_angle: float,
    tolerance_ranges=None,
) -> List[float]:
    """Top-layer angle sweep list (MatchToolDlg.cpp:803-828).

    Without ranges: [0, step, ..., <=tol+step) then (-step, ..., >-tol-step);
    with ranges: [t1 .. t2+step) and [t3 .. t4+step) stepped forward.
    """
    step = angle_step(templ_hw)
    angles: List[float] = []
    if tolerance_ranges is not None:
        t1, t2, t3, t4 = tolerance_ranges
        a = t1
        while a < t2 + step:
            angles.append(a)
            a += step
        a = t3
        while a < t4 + step:
            angles.append(a)
            a += step
    else:
        if tolerance_angle < VISION_TOLERANCE:
            angles.append(0.0)
        else:
            a = 0.0
            while a < tolerance_angle + step:
                angles.append(a)
                a += step
            a = -step
            while a > -tolerance_angle - step:
                angles.append(a)
                a -= step
    return angles


def best_rotation_size(
    src_wh: Tuple[int, int], dst_wh: Tuple[int, int], angle_deg: float
) -> Tuple[int, int]:
    """Tight rotation canvas (width, height) for rotating the source by
    `angle_deg` when searching for a dst_wh template — GetBestRotationSize
    (MatchToolDlg.cpp:1401-1468), including its angle-reduction branches and
    wrong-size fallback.
    """
    sw, sh = src_wh
    dw, dh = dst_wh
    a_rad = angle_deg * D2R
    center = np.array([(sw - 1) / 2.0, (sh - 1) / 2.0])
    corners = np.array(
        [[0, 0], [0, sh - 1], [sw - 1, sh - 1], [sw - 1, 0]], dtype=np.float64)
    rot = rotate_pt(corners, center, a_rad)
    top_y = float(np.max(rot[:, 1]))
    bottom_y = float(np.min(rot[:, 1]))
    right_x = float(np.max(rot[:, 0]))
    left_x = float(np.min(rot[:, 0]))

    a = angle_deg
    if a > 360:
        a -= 360
    elif a < 0:
        a += 360

    if (abs(abs(a) - 90) < VISION_TOLERANCE
            or abs(abs(a) - 270) < VISION_TOLERANCE):
        return (sh, sw)
    if abs(a) < VISION_TOLERANCE or abs(abs(a) - 180) < VISION_TOLERANCE:
        return (sw, sh)

    # Reduce to (0, 90) as the reference does (MatchToolDlg.cpp:1432-1447).
    if 0 < a < 90:
        pass
    elif 90 < a < 180:
        a -= 90
    elif 180 < a < 270:
        a -= 180
    elif 270 < a < 360:
        a -= 270

    fh1 = dw * math.sin(a * D2R) * math.cos(a * D2R)
    fh2 = dh * math.sin(a * D2R) * math.cos(a * D2R)
    half_h = int(math.ceil(top_y - center[1] - fh1))
    half_w = int(math.ceil(right_x - center[0] - fh2))
    ret_w, ret_h = half_w * 2, half_h * 2

    wrong = ((dw < ret_w and dh > ret_h)
             or (dw > ret_w and dh < ret_h)
             or dw * dh > ret_w * ret_h)
    if wrong:
        ret_w = int(right_x - left_x + 0.5)
        ret_h = int(top_y - bottom_y + 0.5)
    return (ret_w, ret_h)


def pyr_down_size(hw: Tuple[int, int]) -> Tuple[int, int]:
    """cv::pyrDown default output size: ((h+1)/2, (w+1)/2)."""
    return ((hw[0] + 1) // 2, (hw[1] + 1) // 2)


def pyramid_sizes(hw: Tuple[int, int], levels: int) -> List[Tuple[int, int]]:
    """Shapes of pyramid levels 0..levels (inclusive)."""
    out = [hw]
    for _ in range(levels):
        out.append(pyr_down_size(out[-1]))
    return out
