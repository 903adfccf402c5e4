"""The comparison that decides `correct` for glyph reads: the port's read
of each plate (setups/glyphs.py::rows) against the plain reference's
(reference/ocr.py) for the same plate. Six numbers are read over all
answers of a run, each held to its limit:

  text_diff      plates whose string differs from the reference's;
  label_diff     the most kept matches of one plate, on either side, left
                 without a match of the same label on the other (each
                 match of the reference pairs with at most one);
  count_diff     the most by which a plate's number of kept matches
                 differs from the reference's;
  score_gap, centre_gap_px, angle_gap_deg
                 as comparisons/match_lists.py reads them, over the
                 matches of each label: each reference match of a label
                 (best first) paired with the nearest unpaired match of
                 the same label by centre.
"""

from __future__ import annotations

import os

import numpy as np

from fipm_bench import run

NUMBERS = ("text_diff", "label_diff", "count_diff", "score_gap",
           "centre_gap_px", "angle_gap_deg")
GAPS = ("score_gap", "centre_gap_px", "angle_gap_deg")

_lists = run.load_module(os.path.join(run.BENCH_DIR, "comparisons",
                                      "match_lists.py"))


def answer_numbers(got: dict, want: dict) -> dict:
    """The six numbers of one plate's read against the reference's."""
    a = np.asarray(got["rows"], np.float64).reshape(-1, 5)
    b = np.asarray(want["rows"], np.float64).reshape(-1, 5)
    out = {"text_diff": float(got["text"] != want["text"]),
           "label_diff": 0.0,
           "count_diff": float(abs(len(a) - len(b)))}
    out.update({k: 0.0 for k in GAPS})
    for label in np.union1d(a[:, 0], b[:, 0]):
        mine, theirs = a[a[:, 0] == label, 1:], b[b[:, 0] == label, 1:]
        out["label_diff"] += abs(len(mine) - len(theirs))
        nums = _lists.answer_numbers(mine, theirs)
        for k in GAPS:
            out[k] = max(out[k], nums[k])
    return out


def judge(answers, reference, limits: dict) -> dict:
    """answers: (pool index, rows) for every answer of the run; reference:
    pool index -> rows; limits: number -> limit.

    Returns {"numbers": text_diff summed over the answers and the widest
    reading of each other number, "failed": the answers that break a
    limit, "correct": bool}."""
    out = {k: 0.0 for k in NUMBERS}
    failed = 0
    for i, rows in answers:
        nums = answer_numbers(rows, reference[i])
        out["text_diff"] += nums["text_diff"]
        for k in NUMBERS[1:]:
            out[k] = max(out[k], nums[k])
        if any(nums[k] > limits[k] for k in NUMBERS):
            failed += 1
    return {"numbers": out, "failed": failed,
            "correct": failed == 0 and len(answers) > 0}
