"""Multi-template (glyph/OCR-style) matching — the port of
fastest_image_pattern_matching_tpu/models/multi_template.py.

The reference ships an OCR demo: a disabled 36-glyph loop over the
`Test Images/M12/` character templates, matching each glyph pattern
against the source in turn (MatchTool/MatchToolDlg.cpp:714-771). Here:
learn N patterns once, match them against one source, label the results,
and optionally resolve overlaps across templates with the same greedy
rotated-rect NMS.

The JAX package's cross-template NMS calls the C++ greedy of its native
library and returns the matches unfiltered when that library cannot be
built. The port runs ops/nms.py::filter_overlaps in float64 on the CPU
instead, always: the same greedy and the same clip, with no fallback.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import MatchConfig
from ..ops.nms import filter_overlaps
from ..types import LearnedPattern, MatchResult
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .template_matcher import _results, learn_pattern, match


@dataclasses.dataclass
class LabeledMatch:
    label: str
    result: MatchResult


class MultiTemplateMatcher:
    """Learn a dictionary of templates; find all of them in a source.

    cross_nms resolves overlapping detections of different templates by
    score (the reference's per-glyph loop has no cross-glyph suppression;
    it is optional and off by default for parity).
    """

    def __init__(self, config: Optional[MatchConfig] = None, device=None):
        self.config = config or MatchConfig()
        self.device = resolve_device(device)
        self.patterns: Dict[str, LearnedPattern] = {}

    def learn(self, label: str, templ: np.ndarray) -> None:
        self.patterns[label] = learn_pattern(
            templ, self.config.min_reduce_area, device=self.device)

    def learn_glyph_dir(self, directory: str) -> None:
        """Learn every image in a directory as a glyph (file stem = label),
        like the M12 glyph set. BMP files need no image library."""
        from ..utils.imageio import load_gray
        for p in sorted(glob.glob(os.path.join(directory, "*"))):
            if not p.lower().endswith((".bmp", ".jpg", ".png", ".jpeg")):
                continue
            label = os.path.splitext(os.path.basename(p))[0]
            try:
                self.learn(label, load_gray(p))
            except ValueError:
                continue

    def match_all(self, src: np.ndarray, cross_nms: bool = False,
                  batched: bool = True) -> List[LabeledMatch]:
        """batched=True (default) runs the glyph set through
        models.batch.match_patterns (the source pyramid built once, the
        sweep canvases once per group of same-shaped glyphs); batched=False
        matches glyph by glyph, the reference's structure. The call is
        the span fipm.ocr."""
        with span("fipm.ocr"):
            labels, pats = [], []
            for label, pat in self.patterns.items():
                t0 = pat.levels[0].templ
                if t0.shape[0] * t0.shape[1] > src.shape[0] * src.shape[1]:
                    continue  # template larger than source
                labels.append(label)
                pats.append(pat)
            out: List[LabeledMatch] = []
            if batched and pats:
                from .batch import match_patterns
                arrs = match_patterns(src, pats, self.config,
                                      device=self.device)
                for label, pat, arr in zip(labels, pats, arrs):
                    out.extend(LabeledMatch(label, r)
                               for r in _results(arr, pat))
            else:
                for label, pat in zip(labels, pats):
                    try:
                        results = match(src, pat, self.config,
                                        device=self.device)
                    except ValueError:
                        continue
                    out.extend(LabeledMatch(label, r) for r in results)
            out.sort(key=lambda m: -m.result.score)
            if cross_nms and out:
                out = self._cross_nms(out)
            return out

    def _cross_nms(self, matches: List[LabeledMatch]) -> List[LabeledMatch]:
        """Greedy cross-template suppression in score order, in float64 on
        the CPU; the median rect area is the ratio base. The span
        fipm.ocr.cross_nms; the counters ocr.matches and ocr.kept add the
        matches in and those kept."""
        with span("fipm.ocr.cross_nms"):
            quads = torch.tensor([[m.result.lt, m.result.rt, m.result.rb,
                                   m.result.lb] for m in matches],
                                 dtype=torch.float64)
            areas = [abs(np.linalg.norm(np.subtract(m.result.rt,
                                                    m.result.lt))
                         * np.linalg.norm(np.subtract(m.result.lb,
                                                      m.result.lt)))
                     for m in matches]
            keep = filter_overlaps(quads, torch.ones(len(matches),
                                                     dtype=torch.bool),
                                   float(np.median(areas)),
                                   self.config.max_overlap)
            kept = [m for m, k in zip(matches, keep.tolist()) if k]
            count("ocr.matches", len(matches))
            count("ocr.kept", len(kept))
            return kept


def match_glyphs(src: np.ndarray, glyph_dir: str,
                 config: Optional[MatchConfig] = None,
                 cross_nms: bool = True, device=None) -> List[LabeledMatch]:
    """One-call OCR-style glyph matching (the M12 demo as an API)."""
    m = MultiTemplateMatcher(config or MatchConfig(
        max_pos=10, score=0.8, tolerance_angle=0.0), device=device)
    m.learn_glyph_dir(glyph_dir)
    return m.match_all(src, cross_nms=cross_nms)


def read_string(matches: Sequence[LabeledMatch], min_score: float = 0.0,
                x_merge: float = 12.0) -> str:
    """Assemble the left-to-right string from labeled glyph matches — the
    read-out step of the reference's OCR demo (which stamps per-glyph
    results onto the image, MatchToolDlg.cpp:745-760; here a string).

    Glyphs below min_score are dropped; matches within x_merge px of the
    last ACCEPTED glyph's anchor position are treated as duplicate
    detections of the same character (keep the best score). The anchor
    does not move when a better-scoring duplicate replaces the kept one,
    so the merge window cannot chain across a row of distinct glyphs —
    but x_merge must still be below the glyph pitch, or alternating
    characters are swallowed. The call is the span fipm.ocr.read."""
    with span("fipm.ocr.read"):
        hits = [m for m in matches if m.result.score >= min_score]
        hits.sort(key=lambda m: m.result.pos_x)
        out: List[LabeledMatch] = []
        anchor_x = None
        for m in hits:
            if out and abs(m.result.pos_x - anchor_x) < x_merge:
                if m.result.score > out[-1].result.score:
                    out[-1] = m
                continue
            out.append(m)
            anchor_x = m.result.pos_x
        return "".join(m.label for m in out)
