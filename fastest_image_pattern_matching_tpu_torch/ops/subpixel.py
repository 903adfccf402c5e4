"""Subpixel (x, y, theta) refinement via a quadratic surface fit.

The reference fits a 10-coefficient quadratic over a 3x3x3 (x, y, theta)
score neighbourhood by 27x10 least squares and solves a 3x3 system for the
stationary point (SubPixEsimation, MatchTool/MatchToolDlg.cpp:1149-1221).
In centred, normalised coordinates the design matrix is a constant, so the
fit is one [10, 27] pseudo-inverse product and a closed-form 3x3 solve.
"""

from __future__ import annotations

import numpy as np
import torch

from .rounding import f32


def _design_pinv() -> np.ndarray:
    """Pseudo-inverse of the 27x10 quadratic design matrix over the unit
    3x3x3 grid, row order (theta, y, x) like the reference's loop nest."""
    rows = []
    for t in (-1.0, 0.0, 1.0):
        for y in (-1.0, 0.0, 1.0):
            for x in (-1.0, 0.0, 1.0):
                rows.append([x * x, y * y, t * t, x * y, x * t, y * t,
                             x, y, t, 1.0])
    return np.linalg.pinv(np.array(rows, dtype=np.float64))  # [10, 27]


_PINV = _design_pinv().astype(np.float32)


def subpixel_refine(patches: torch.Tensor, step_rad: float) -> torch.Tensor:
    """Stationary point of the fitted quadratic.

    patches: [..., 3, 3, 3] scores ordered (theta, dy, dx).
    step_rad: angle step in radians.

    Returns [..., 3]: (dx, dy, dtheta_rad) offsets from the centre sample.
    Degenerate fits (|det| <= 1e-20) give a zero offset, never NaN.
    """
    s = patches.reshape(*patches.shape[:-3], 27)
    # The 27-term fit as f64 sums of the exact f32 products, rounded to
    # f32 once: an f32 matmul's summation order, hence its last bits,
    # depends on how many fits it computes together on the card (a batch
    # of frames fits more candidates in one call), and an ill-conditioned
    # fit moves the stationary point by up to 1e-3 px for one ulp.
    pinv = torch.as_tensor(_PINV, device=patches.device)
    z = (s.to(torch.float64) @ pinv.to(torch.float64).T).to(torch.float32)
    k0, k1, k2, k3, k4, k5, k6, k7, k8 = (z[..., i] for i in range(9))

    # Solve [2k0 k3 k4; k3 2k1 k5; k4 k5 2k2] d = -[k6 k7 k8]
    a, b, c = 2 * k0, k3, k4
    d_, e, f = k3, 2 * k1, k5
    g, h, i = k4, k5, 2 * k2
    det = a * (e * i - f * h) - b * (d_ * i - f * g) + c * (d_ * h - e * g)
    safe = torch.abs(det) > 1e-20
    det = torch.where(safe, det, 1.0)
    rx = -k6, -k7, -k8
    dx = (rx[0] * (e * i - f * h) - b * (rx[1] * i - f * rx[2])
          + c * (rx[1] * h - e * rx[2])) / det
    dy = (a * (rx[1] * i - f * rx[2]) - rx[0] * (d_ * i - f * g)
          + c * (d_ * rx[2] - rx[1] * g)) / det
    dt = (a * (e * rx[2] - rx[1] * h) - b * (d_ * rx[2] - rx[1] * g)
          + rx[0] * (d_ * h - e * g)) / det
    dx = torch.where(safe, dx, 0.0)
    dy = torch.where(safe, dy, 0.0)
    dt = torch.where(safe, dt, 0.0)
    return torch.stack([dx, dy, dt * f32(step_rad)], dim=-1)
