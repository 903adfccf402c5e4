"""The comparison that decides `correct` for match lists: the port's
against the plain reference's, frame by frame.

Each answer (one frame's match list from the timed path) is held against
the reference's list for the same frame. Four numbers are read over all
answers of a run, each held to its limit:

  count_diff     the most by which an answer's number of matches differs
                 from the reference's (exact: limit 0);
  score_gap      the widest |score - reference score| of a paired match;
  centre_gap_px  the widest distance between paired centres, in pixels;
  angle_gap_deg  the widest |angle - reference angle|, wrapped, in degrees.

Matches are paired greedily, each reference match (best first) with the
nearest unpaired match of the answer by centre.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("count_diff", "score_gap", "centre_gap_px", "angle_gap_deg")


def answer_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """The four numbers of one answer. got, want: [n, 4] rows of (score,
    angle deg, centre x, centre y)."""
    got = np.asarray(got, np.float64).reshape(-1, 4)
    want = np.asarray(want, np.float64).reshape(-1, 4)
    out = {"count_diff": float(abs(len(got) - len(want))),
           "score_gap": 0.0, "centre_gap_px": 0.0, "angle_gap_deg": 0.0}
    free = list(range(len(got)))
    for r in want:
        if not free:
            break
        d = [math.hypot(got[j, 2] - r[2], got[j, 3] - r[3]) for j in free]
        k = int(np.argmin(d))
        g = got[free.pop(k)]
        out["score_gap"] = max(out["score_gap"], abs(g[0] - r[0]))
        out["centre_gap_px"] = max(out["centre_gap_px"], d[k])
        da = abs((g[1] - r[1] + 180.0) % 360.0 - 180.0)
        out["angle_gap_deg"] = max(out["angle_gap_deg"], da)
    return out


def judge(answers, reference, limits: dict) -> dict:
    """answers: (pool index, [n, 4] rows) for every answer of the run;
    reference: pool index -> [n, 4] rows; limits: number -> limit.

    Returns {"numbers": the widest reading of each number, "failed": the
    answers that break a limit, "correct": bool}."""
    widest = {k: 0.0 for k in NUMBERS}
    failed = 0
    for i, rows in answers:
        nums = answer_numbers(rows, reference[i])
        for k in NUMBERS:
            widest[k] = max(widest[k], nums[k])
        if any(nums[k] > limits[k] for k in NUMBERS):
            failed += 1
    return {"numbers": widest, "failed": failed,
            "correct": failed == 0 and len(answers) > 0}
