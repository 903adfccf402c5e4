"""The plain OCR reference: one plate, one glyph set, in PyTorch.

The read of the reference tool's 36-glyph M12 demo (MatchTool/
MatchToolDlg.cpp:714-771: every glyph pattern matched against one source
in turn), with the port's cross-glyph suppression and its left-to-right
read-out (models/multi_template.py: MultiTemplateMatcher.match_all with
cross_nms, then read_string), written out plainly:

  * each glyph of the set, in the set's order, matched alone by the
    reference matcher (matcher.py::match) at the configuration's `match`
    settings, with its own template pyramid and the plate's; a glyph of
    more pixels than the plate is skipped, as the port skips it;
  * each match's rotated rectangle (LT, RT, RB, LB) at the glyph's level-0
    size, turned by the match's angle about its top-left corner;
  * all labelled matches sorted by score, best first; the sort is stable,
    so equal scores keep glyph order, then each glyph's own rank;
  * with `cross_nms`, the greedy suppression across glyphs in float64:
    walking that order, each survivor deletes every later match whose
    rectangle it contains or overlaps by more than `max_overlap` of the
    median rectangle area (its pair areas from ops.py's convex clip);
  * the read: the survivors of at least `score`, by centre x (stable),
    a match within 12 px of the last accepted glyph's x replacing it when
    it scores higher, the accepted glyph's x staying the anchor.

Where the port computes the same thing another way: the port builds the
plate's pyramid once a call and the top-layer canvases once for the
glyphs of one plan, where this matches each glyph from scratch; the port
builds a rectangle in float32 from the match's top-left corner, where
this rebuilds it in float64 from the centre and angle that matcher.match
returns (the corners agree to float32 rounding, far from any overlap
decision of a glyph row); the port decides the suppression in parallel
rounds (ops/nms.py), where this walks the greedy order, which gives the
same survivors.

It imports nothing of the port and nothing of JAX. `answer` is the entry
the harness calls, by the name `ocr` that a configuration gives as its
`reference`; `score_dtype` (a configuration's control) names the dtype
the NCC scores are kept in, as for the matcher.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fipm_bench.reference import matcher
from fipm_bench.reference import ops

# read_string's default: matches this close in x are one glyph.
X_MERGE = 12.0


def rectangle(centre, angle_deg: float, w: float, h: float) -> np.ndarray:
    """The corners [4, 2] (LT, RT, RB, LB) of a w x h rectangle turned by
    angle_deg about its top-left corner, placed by its centre: the port's
    construction (the top-left corner, then the sides w and h along the
    turned axes) solved for the corner from the centre."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    lt = np.array([centre[0] - (w * c + h * s) / 2.0,
                   centre[1] - (h * c - w * s) / 2.0])
    rt = lt + w * np.array([c, -s])
    down = h * np.array([s, c])
    return np.stack([lt, rt, rt + down, lt + down])


def cross_nms(quads: np.ndarray, max_overlap: float) -> np.ndarray:
    """The keep mask [n] of score-sorted rectangles quads [n, 4, 2] under
    the greedy cross-glyph suppression, in float64, over the median
    rectangle area."""
    n = quads.shape[0]
    sides = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=1) \
        * np.linalg.norm(quads[:, 3] - quads[:, 0], axis=1)
    base = float(np.median(np.abs(sides)))
    q = torch.as_tensor(quads, dtype=torch.float64)
    qa = q[:, None].expand(n, n, 4, 2).reshape(n * n, 4, 2)
    qb = q[None].expand(n, n, 4, 2).reshape(n * n, 4, 2)
    pair = ops.quad_area(qa, qb).reshape(n, n).numpy()
    conflict = (pair >= base * (1.0 - 1e-6)) | (pair / base > max_overlap)
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~conflict[i, i + 1:]
    return keep


def read(labels, matches, min_score: float) -> str:
    """The string of (label index, score, angle, centre x, centre y)
    matches, left to right."""
    hits = sorted((m for m in matches if m[1] >= min_score),
                  key=lambda m: m[3])
    out, anchor = [], None
    for m in hits:
        if out and abs(m[3] - anchor) < X_MERGE:
            if m[1] > out[-1][1]:
                out[-1] = m
            continue
        out.append(m)
        anchor = m[3]
    return "".join(labels[int(m[0])] for m in out)


def answer(frame_u8: np.ndarray, glyphs: dict, config: dict, device,
           work=None, score_dtype="float32") -> dict:
    """The reference's read of one plate: {"text": the string, "rows":
    [n, 5] f64 rows of (label index in the glyph set, score, angle deg,
    centre x, centre y) of the kept labelled matches, best first}.

    glyphs: label -> u8 template, in the set's order. config: the
    configuration (`match` settings, `cross_nms`). work: a list that
    collects the matcher's device work (matcher.py's note)."""
    cfg = config["match"]
    dtype = getattr(torch, score_dtype)
    labels = list(glyphs)
    area = frame_u8.shape[0] * frame_u8.shape[1]
    found, quads = [], []
    for li, label in enumerate(labels):
        g = np.asarray(glyphs[label])
        if g.shape[0] * g.shape[1] > area:
            continue
        for r in matcher.match(frame_u8, g, cfg, device, dtype, work):
            found.append((float(li), *map(float, r)))
            quads.append(rectangle(r[2:4], r[1], float(g.shape[1]),
                                   float(g.shape[0])))
    order = sorted(range(len(found)), key=lambda k: -found[k][1])
    found = [found[k] for k in order]
    if config["cross_nms"] and found:
        keep = cross_nms(np.stack([quads[k] for k in order]),
                         cfg["max_overlap"])
        found = [m for m, k in zip(found, keep) if k]
    return {"text": read(labels, found, cfg["score"]),
            "rows": np.array(found, np.float64).reshape(-1, 5)}
