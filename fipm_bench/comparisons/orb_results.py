"""The comparison that decides `correct` for ORB registrations: the port's
answer for each frame (setups/orb.py::rows of its ORBResult) against the
plain reference's (reference/orb.py) for the same frame. Four numbers are
read over all answers of a run, each held to its limit:

  matched_diff   frames whose is_matched differs;
  inlier_diff    the largest |num_inliers - reference num_inliers|;
  good_diff      the most good-match point pairs of one frame that
                 differ from the reference's, position by position
                 (a pair missing on one side counts as differing);
  corner_gap_px  the largest distance between a corner and the
                 reference's, over frames that both match.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("matched_diff", "inlier_diff", "good_diff", "corner_gap_px")


def answer_numbers(got: dict, want: dict) -> dict:
    """The four numbers of one frame's answer against the reference's."""
    a, b = np.asarray(got["pairs"]), np.asarray(want["pairs"])
    n = min(len(a), len(b))
    differ = int((a[:n] != b[:n]).any(1).sum()) + abs(len(a) - len(b))
    gap = 0.0
    if got["matched"] and want["matched"]:
        gap = float(np.linalg.norm(np.asarray(got["corners"])
                                   - np.asarray(want["corners"]), axis=1
                                   ).max())
    return {"matched_diff": float(got["matched"] != want["matched"]),
            "inlier_diff": float(abs(got["inliers"] - want["inliers"])),
            "good_diff": float(differ), "corner_gap_px": gap}


def judge(answers, reference, limits: dict) -> dict:
    """answers: (pool index, rows) for every answer of the run; reference:
    pool index -> rows; limits: number -> limit.

    Returns {"numbers": matched_diff summed over the answers and the
    widest reading of each other number, "failed": the answers that
    break a limit, "correct": bool}."""
    out = {k: 0.0 for k in NUMBERS}
    failed = 0
    for i, rows in answers:
        nums = answer_numbers(rows, reference[i])
        out["matched_diff"] += nums["matched_diff"]
        for k in NUMBERS[1:]:
            out[k] = max(out[k], nums[k])
        if any(nums[k] > limits[k] for k in NUMBERS):
            failed += 1
    return {"numbers": out, "failed": failed,
            "correct": failed == 0 and len(answers) > 0}
