"""Drawing primitives shared by the scene generators: a template drawn
from a list of shapes, and a template pasted rotated into a frame."""

from __future__ import annotations

import math

import numpy as np


def _rect(img, x0, y0, x1, y1, val, thick):
    """Outline of the rectangle (x0, y0)-(x1, y1), thick/2 pixels either
    side of the line, like cv2.rectangle."""
    h = thick // 2
    img[y0 - h:y0 + h + 1, x0 - h:x1 + h + 1] = val
    img[y1 - h:y1 + h + 1, x0 - h:x1 + h + 1] = val
    img[y0 - h:y1 + h + 1, x0 - h:x0 + h + 1] = val
    img[y0 - h:y1 + h + 1, x1 - h:x1 + h + 1] = val


def _disc(img, cx, cy, r, val):
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]]
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = val


def _line(img, x0, y0, x1, y1, val, thick):
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / (dx * dx + dy * dy), 0, 1)
    img[np.hypot(xx - (x0 + t * dx), yy - (y0 + t * dy)) <= thick / 2.0] = val


def template(spec: dict, rng) -> np.ndarray:
    """A u8 template of spec["hw"] filled with spec["fill"], the shapes of
    spec["shapes"] drawn in order, then noise in [0, spec["noise"]) added
    from rng. A shape is {"rect": [x0, y0, x1, y1], "thick": t}, {"disc":
    [cx, cy, r]}, {"line": [x0, y0, x1, y1], "thick": t} or {"box": [x0,
    y0, x1, y1]} (filled, exclusive ends), each with its grey "val"."""
    h, w = spec["hw"]
    t = np.full((h, w), spec["fill"], np.uint8)
    for s in spec["shapes"]:
        if "rect" in s:
            _rect(t, *s["rect"], s["val"], s["thick"])
        elif "disc" in s:
            _disc(t, *s["disc"], s["val"])
        elif "line" in s:
            _line(t, *s["line"], s["val"], s["thick"])
        elif "box" in s:
            x0, y0, x1, y1 = s["box"]
            t[y0:y1, x0:x1] = s["val"]
        else:
            raise ValueError(f"unknown shape {s}")
    noise = rng.integers(0, spec["noise"], t.shape)
    return np.minimum(t.astype(np.int32) + noise, 255).astype(np.uint8)


def paste_rotated(scene, templ, cx, cy, angle_deg):
    """Paste templ turned by angle_deg (cv::getRotationMatrix2D's sense,
    bilinear) about (cx, cy) into scene; returns the centre the matcher
    reports for it: template point (w/2, h/2) in pixel-centre
    coordinates, in the scene."""
    from scipy import ndimage
    th, tw = templ.shape
    diag = int(np.ceil(np.hypot(th, tw))) + 4
    canvas = np.zeros((diag, diag), np.float64)
    mask = np.zeros((diag, diag), np.float64)
    y0, x0 = (diag - th) // 2, (diag - tw) // 2
    canvas[y0:y0 + th, x0:x0 + tw] = templ
    mask[y0:y0 + th, x0:x0 + tw] = 1.0
    c = (diag - 1) / 2.0
    a = math.radians(angle_deg)
    al, be = math.cos(a), math.sin(a)
    fwd = np.array([[al, be, (1 - al) * c - be * c],
                    [-be, al, be * c + (1 - al) * c]])
    det = fwd[0, 0] * fwd[1, 1] - fwd[0, 1] * fwd[1, 0]
    inv_lin = np.array([[fwd[1, 1], -fwd[0, 1]],
                        [-fwd[1, 0], fwd[0, 0]]]) / det
    inv_t = -inv_lin @ fwd[:, 2]
    # scipy indexes (row, col): src_rc = M_rc @ dst_rc + off_rc.
    m_rc = np.array([[inv_lin[1, 1], inv_lin[1, 0]],
                     [inv_lin[0, 1], inv_lin[0, 0]]])
    off_rc = np.array([inv_t[1], inv_t[0]])
    rc = ndimage.affine_transform(canvas, m_rc, off_rc, order=1,
                                  mode="constant", cval=0.0)
    rm = ndimage.affine_transform(mask, m_rc, off_rc, order=0,
                                  mode="constant", cval=0.0)
    rc = np.clip(np.rint(rc), 0, 255).astype(np.uint8)
    ys, xs = int(round(cy - c)), int(round(cx - c))
    reg = scene[max(ys, 0):ys + diag, max(xs, 0):xs + diag]
    rm2 = rm[:reg.shape[0], :reg.shape[1]] > 0.5
    reg[rm2] = rc[:reg.shape[0], :reg.shape[1]][rm2]
    centre = fwd @ np.array([x0 + tw / 2.0, y0 + th / 2.0, 1.0])
    return float(centre[0] + xs), float(centre[1] + ys)
