"""Batched matching: many frames (or many templates) per call — the port
of fastest_image_pattern_matching_tpu/models/batch.py.

The reference's deployment mode is a repeated Execute loop over camera
frames (MatchTool/MatchToolDlg.cpp:714; src/CameraPreviewDialog.cpp:84-131
feeds frames to the same matcher). Here the frames of a batch are the
leading axis of every stage of the pipeline (models/template_matcher.py::
build_stages): the sweep's canvases of all frames go through one warp
launch per chunk (the warp kernel takes a stack of sources) and one
correlation per chunk, the peak rounds serve all frames' maps at once, the
descent warps the candidates of all frames together, and the NMS rounds
run once for the batch. The results come back in one host copy. So the
frames share the launches and host syncs that one frame pays alone.

The JAX package compiles one program per batch size and pads a batch to
a power-of-two bucket for that; eager PyTorch compiles nothing, so padded
frames are not computed. `batch_bucket` is kept for the interface and its
check (it may not be smaller than the batch).

Glyph-batched matching (match_patterns) is the same idea along the
template axis: the reference's OCR demo loops 36 glyph patterns over one
source (MatchToolDlg.cpp:714-771); here the source pyramid is built once
per call, and the patterns of one plan group run as one stacked pipeline,
the pattern the row axis of every stage where the frame was (build_stages
with a StackLevel per level): one upload of the group's templates, one
score-map correlation and one peak extraction for all of them, one
descent (one descent-score launch a chunk on the card, each ROI against
its own template) and one finalize over the group's rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MatchConfig
from ..ops.pyramid import build_pyramid
from ..types import LearnedPattern, MatchResult
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .template_matcher import (_check_area, _finalized, _frames,
                               _make_plan, _match_frames, _pack_result,
                               _prep_src, _results, _stack_inputs, _stacked,
                               _sweep_inputs, build_stages, upload_frames)


def _next_bucket(n: int) -> int:
    """Power-of-two batch bucket (the JAX package's compile bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def match_many_arrays(
    srcs, pattern: LearnedPattern, cfg: Optional[MatchConfig] = None,
    batch_bucket: Optional[int] = None, device=None,
) -> Dict[str, np.ndarray]:
    """Match one pattern against B frames as one batch.

    srcs: [B, H, W] (numpy u8/float, or a tensor; one on the device is
    used without a copy). Returns stacked result arrays: score/angle
    [B, max_pos], center [B, max_pos, 2], corners [B, max_pos, 4, 2],
    valid [B, max_pos]. Each frame's result equals match_arrays of that
    frame.

    batch_bucket: the JAX package's static batch size; here only checked
    (it may not be below B), since padded frames are not computed.
    """
    with span("fipm.match_many"):
        return _stacked(_match_many(srcs, pattern, cfg or MatchConfig(),
                                    batch_bucket, device))


def _match_many(srcs, pattern: LearnedPattern, cfg: MatchConfig,
                batch_bucket: Optional[int], device
                ) -> List[Dict[str, np.ndarray]]:
    """The frames [B, H, W] through the input step and the batch's guards
    (the template's area, the bucket), then the batch path; each frame's
    result arrays."""
    frames = _frames(srcs)
    B = frames.shape[0]
    _check_area(pattern, frames.shape[1:])
    bucket = batch_bucket or _next_bucket(B)
    if bucket < B:
        raise ValueError(f"batch_bucket {bucket} < batch {B}")
    return _match_frames(frames, pattern, cfg, device)


def _results_from_arrays(out: Dict[str, np.ndarray], i: int,
                         pattern: LearnedPattern) -> List[MatchResult]:
    return _results({k: v[i] for k, v in out.items()}, pattern)


def match_many(srcs, pattern: LearnedPattern,
               cfg: Optional[MatchConfig] = None,
               batch_bucket: Optional[int] = None,
               device=None) -> List[List[MatchResult]]:
    """Batched front door: B frames in, a MatchResult list per frame out
    (see match_many_arrays)."""
    cfg = cfg or MatchConfig()
    with span("fipm.match_many"):
        outs = _match_many(srcs, pattern, cfg, batch_bucket, device)
        with span("fipm.results"):
            return [_results(o, pattern) for o in outs]


class BatchMatcher:
    """Serving-shape wrapper: holds (pattern, config, device) and matches
    frame batches as they arrive, the streaming analogue of the
    reference's camera -> Execute loop (src/CameraPreviewDialog.cpp:
    84-131)."""

    def __init__(self, pattern: LearnedPattern,
                 config: Optional[MatchConfig] = None,
                 batch_size: int = 8, device=None):
        self.pattern = pattern
        self.config = config or MatchConfig()
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def warmup(self, frame_shape: Tuple[int, int]) -> None:
        """Run one batch of blank frames of this shape, so that the
        kernels are built and loaded before the first real batch."""
        dummy = np.zeros((self.batch_size,) + tuple(frame_shape), np.uint8)
        match_many_arrays(dummy, self.pattern, self.config,
                          batch_bucket=self.batch_size, device=self.device)

    def match_batch(self, frames) -> List[List[MatchResult]]:
        return match_many(frames, self.pattern, self.config,
                          batch_bucket=max(self.batch_size,
                                           _next_bucket(len(frames))),
                          device=self.device)


# ---------------------------------------------------------------------------
# Template-axis batching (glyph sets / OCR).
# ---------------------------------------------------------------------------

def _pattern_groups(patterns: Sequence[LearnedPattern]
                    ) -> Dict[tuple, List[int]]:
    """Pattern indices grouped by (pyramid shapes, flat-template flags,
    border color), which fix the plan, and by the levels' u8-valued
    flags, which decide a stacked descent's route: a template off the
    descent-score kernel's integer route sends only its own group to the
    plain version."""
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(patterns):
        key = (tuple(p.shapes),
               tuple(bool(lv.result_equal1) for lv in p.levels),
               p.border_color,
               tuple(bool(lv.u8_valued) for lv in p.levels))
        groups.setdefault(key, []).append(i)
    return groups


def _source_pyramid(src, patterns: Sequence[LearnedPattern],
                    cfg: MatchConfig, dev):
    """One source [H, W] through the input step; its (H, W) and its
    pyramid on `dev`, deep enough for every pattern."""
    frames = _frames(src, one=True)
    return frames.shape[1:], build_pyramid(
        _prep_src(upload_frames(frames, dev), cfg),
        max(p.top_layer for p in patterns))


def _match_group(pyr, src_hw, group: Sequence[LearnedPattern],
                 cfg: MatchConfig, dev):
    """The G patterns of one plan against the source pyramid as one
    stacked pipeline, up to their descended candidates (the span
    fipm.patterns.pattern; the counter patterns.stacked adds G). Returns
    the plan and the group's finalize for _finalized: nms_cap -> the
    packed results [G, max_pos + 1, 13] on `dev` (again in the span
    fipm.patterns.pattern)."""
    plan = _make_plan(tuple(src_hw), group[0], cfg)
    stats, templs = _stack_inputs(group, dev)
    st = build_stages(plan, stats, dev)
    count("patterns.stacked", len(group))
    with span("fipm.patterns.pattern"):
        cands = st.candidates(pyr[:plan.top + 1], templs,
                              *_sweep_inputs(plan, dev))

    def finalize(nms_cap):
        with span("fipm.patterns.pattern"):
            return _pack_result(st.finalize(*cands, len(group), nms_cap),
                                cfg.max_pos)
    return plan, finalize


def match_patterns(src, patterns: Sequence[LearnedPattern],
                   cfg: Optional[MatchConfig] = None, device=None
                   ) -> List[Dict[str, np.ndarray]]:
    """Match G patterns against one source; returns one result-arrays dict
    per pattern, in input order, each equal to match_arrays of that
    pattern.

    The source pyramid is built once per call. Patterns are grouped by
    (pyramid shapes, flat-template flags, border color), which fix the
    plan, and by their levels' u8-valued flags; a group runs as one
    stacked pipeline (_match_group), and its results come back in one
    host copy under the NMS-cap rule of template_matcher.py::_finalized.
    The JAX package warns when the patterns fall into many groups, because
    each group costs it one compile; eager PyTorch compiles nothing, and a
    group costs one pipeline's launches, so the port does not warn.

    The call is the span fipm.match_patterns, and each group's stages
    (its candidates, and again its finalize) a span
    fipm.patterns.pattern; the counters patterns.groups and patterns.run
    add the call's plan groups and patterns, patterns.stacked the
    patterns that ran stacked (all of them).
    """
    cfg = cfg or MatchConfig()
    dev = resolve_device(device)
    groups = _pattern_groups(patterns)
    if not groups:
        return []
    with span("fipm.match_patterns"):
        src_hw, pyr = _source_pyramid(src, patterns, cfg, dev)
        results: List[Optional[Dict[str, np.ndarray]]] = \
            [None] * len(patterns)
        for idxs in groups.values():
            count("patterns.groups")
            count("patterns.run", len(idxs))
            plan, finalize = _match_group(
                pyr, src_hw, [patterns[i] for i in idxs], cfg, dev)
            for i, out in zip(idxs, _finalized(plan, finalize)):
                results[i] = out
        return results
