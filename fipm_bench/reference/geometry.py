"""Host-side planning geometry of the reference matcher (numpy, f64): a
frozen copy of the reference tool's GetTopLayer, angle list and
GetBestRotationSize as the port plans them. Shapes only, never pixels."""

from __future__ import annotations

import math

import numpy as np

VISION_TOLERANCE = 0.0000001
D2R = math.pi / 180.0
R2D = 180.0 / math.pi


def rotate_pt(pt, org, angle_rad):
    pt = np.asarray(pt, np.float64)
    org = np.asarray(org, np.float64)
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    dx, dy = pt[..., 0] - org[..., 0], pt[..., 1] - org[..., 1]
    return np.stack([org[..., 0] + dx * c + dy * s,
                     org[..., 1] - dx * s + dy * c], axis=-1)


def rotation_matrix(center, angle_deg):
    """cv::getRotationMatrix2D(center, angle_deg, 1)."""
    a = angle_deg * D2R
    al, be = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]], np.float64)


def invert_affine(m):
    a, b, tx = m[0]
    c, d, ty = m[1]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return np.array([[ia, ib, -(ia * tx + ib * ty)],
                     [ic, id_, -(ic * tx + id_ * ty)]], np.float64)


def top_layer(templ_hw, min_reduce_area):
    min_len = int(math.sqrt(float(min_reduce_area)))
    area = templ_hw[0] * templ_hw[1]
    layer = 0
    while area > min_len * min_len:
        area //= 4
        layer += 1
    return layer


def angle_step(templ_hw):
    return math.atan(2.0 / max(templ_hw[0], templ_hw[1])) * R2D


def angle_schedule(templ_hw, tolerance_angle):
    """[0, step, ..] up to tol + step, then [-step, ..] down to -tol - step;
    [0] below the vision tolerance."""
    if tolerance_angle < VISION_TOLERANCE:
        return [0.0]
    step = angle_step(templ_hw)
    out, a = [], 0.0
    while a < tolerance_angle + step:
        out.append(a)
        a += step
    a = -step
    while a > -tolerance_angle - step:
        out.append(a)
        a -= step
    return out


def best_rotation_size(src_wh, dst_wh, angle_deg):
    """GetBestRotationSize: the (w, h) of the rotation canvas."""
    sw, sh = src_wh
    dw, dh = dst_wh
    center = np.array([(sw - 1) / 2.0, (sh - 1) / 2.0])
    corners = np.array([[0, 0], [0, sh - 1], [sw - 1, sh - 1], [sw - 1, 0]],
                       np.float64)
    rot = rotate_pt(corners, center, angle_deg * D2R)
    top_y, bottom_y = float(np.max(rot[:, 1])), float(np.min(rot[:, 1]))
    right_x, left_x = float(np.max(rot[:, 0])), float(np.min(rot[:, 0]))
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
    for lo in (90, 180, 270):
        if lo < a < lo + 90:
            a -= lo
    fh1 = dw * math.sin(a * D2R) * math.cos(a * D2R)
    fh2 = dh * math.sin(a * D2R) * math.cos(a * D2R)
    ret_w = int(math.ceil(right_x - center[0] - fh2)) * 2
    ret_h = int(math.ceil(top_y - center[1] - fh1)) * 2
    if ((dw < ret_w and dh > ret_h) or (dw > ret_w and dh < ret_h)
            or dw * dh > ret_w * ret_h):
        ret_w = int(right_x - left_x + 0.5)
        ret_h = int(top_y - bottom_y + 0.5)
    return (ret_w, ret_h)


def pyramid_sizes(hw, levels):
    out = [tuple(hw)]
    for _ in range(levels):
        out.append(((out[-1][0] + 1) // 2, (out[-1][1] + 1) // 2))
    return out
