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
per call and the sweep canvases once per group of same-shaped patterns,
then each pattern runs the rest of the pipeline on them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MatchConfig
from ..ops.pyramid import build_pyramid
from ..types import LearnedPattern, MatchResult
from ..utils.device import resolve_device
from ..utils.profiling import span
from .template_matcher import (_check_u8, _dispatch, _pack_result,
                               _pattern_inputs, _plan_inputs, _prep_src,
                               _results, _unpack_result, build_stages,
                               match_arrays, upload_frames)


def _next_bucket(n: int) -> int:
    """Power-of-two batch bucket (the JAX package's compile bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _prepare_batch(srcs, pattern: LearnedPattern, cfg: MatchConfig,
                   batch_bucket: Optional[int], dev):
    """Checks, plan and device inputs of a batch [B, H, W]: host frames go
    up in one copy, a tensor on the device is taken without one."""
    if not torch.is_tensor(srcs):
        srcs = np.asarray(srcs)
    if srcs.ndim == 4:
        from ..utils.imageio import ensure_gray
        srcs = ensure_gray(srcs)
    if srcs.ndim != 3:
        raise ValueError(f"srcs must be [B, H, W], got shape "
                         f"{tuple(srcs.shape)}")
    B = srcs.shape[0]
    _check_u8(srcs)
    t0 = pattern.levels[0].templ
    if t0.shape[0] * t0.shape[1] > srcs.shape[1] * srcs.shape[2]:
        raise ValueError("template larger than source")
    bucket = batch_bucket or _next_bucket(B)
    if bucket < B:
        raise ValueError(f"batch_bucket {bucket} < batch {B}")
    plan, stats, args = _plan_inputs(srcs.shape[1:], pattern, cfg, dev)
    return plan, stats, (upload_frames(srcs, dev),) + args


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
        return _match_many_arrays(srcs, pattern, cfg or MatchConfig(),
                                  batch_bucket, device)


def _match_many_arrays(srcs, pattern: LearnedPattern, cfg: MatchConfig,
                       batch_bucket: Optional[int], device
                       ) -> Dict[str, np.ndarray]:
    dev = resolve_device(device)
    with span("fipm.prepare"):
        plan, stats, args = _prepare_batch(srcs, pattern, cfg, batch_bucket,
                                           dev)
        st = build_stages(plan, stats, dev)
    outs = [_unpack_result(p) for p in _dispatch(st, args, cfg)]
    # Frames over the NMS cap (rare) run again alone with the cap lifted.
    for i, o in enumerate(outs):
        if o.pop("nms_overflow") and plan.nms_cap < plan.c_max:
            one = (args[0][i:i + 1],) + args[1:]
            outs[i] = _unpack_result(_dispatch(st, one, cfg, plan.c_max)[0])
            outs[i].pop("nms_overflow")
    return {k: np.stack([o[k] for o in outs])
            for k in ("score", "angle", "center", "corners", "valid")}


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
        out = _match_many_arrays(srcs, pattern, cfg, batch_bucket, device)
        with span("fipm.results"):
            return [_results_from_arrays(out, i, pattern)
                    for i in range(out["valid"].shape[0])]


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
    border color), which fix the plan."""
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(patterns):
        key = (tuple(p.shapes),
               tuple(bool(lv.result_equal1) for lv in p.levels),
               p.border_color)
        groups.setdefault(key, []).append(i)
    return groups


def _source_pyramid(src, patterns: Sequence[LearnedPattern],
                    cfg: MatchConfig, dev):
    """One host source [H, W] as a u8-checked array and its pyramid on
    `dev`, deep enough for every pattern."""
    if not torch.is_tensor(src):
        src = np.asarray(src)
    if src.ndim == 3:
        from ..utils.imageio import ensure_gray
        src = ensure_gray(src)
    _check_u8(src)
    frames = upload_frames(src[None], dev)
    return src, build_pyramid(_prep_src(frames, cfg),
                              max(p.top_layer for p in patterns))


def _match_group(pyr, src_hw, group: Sequence[LearnedPattern],
                 cfg: MatchConfig, dev):
    """Patterns of one plan against the source pyramid, the sweep canvases
    computed once for all. Returns the plan and the packed results
    [G, max_pos + 1, 13] on `dev`."""
    plan, _, (_, *sweep) = _plan_inputs(src_hw, group[0], cfg, dev)
    canvases = None
    packed = []
    for p in group:
        stats, templs = _pattern_inputs(p, dev)
        st = build_stages(plan, stats, dev)
        if canvases is None:
            canvases = st.sweep_canvases(pyr[plan.top], sweep[0])
        out = st.match_from_pyr(pyr[:plan.top + 1], templs, *sweep,
                                canvases=canvases)
        packed.append(_pack_result(out, cfg.max_pos))
    return plan, torch.cat(packed)


def _unpack_group(packed: np.ndarray, plan, src, patterns, idxs, cfg,
                  dev, results) -> None:
    """Results of the patterns idxs from their packed rows; a pattern over
    the NMS cap runs again alone, uncapped."""
    for k, i in enumerate(idxs):
        out = _unpack_result(packed[k])
        if out.pop("nms_overflow") and plan.nms_cap < plan.c_max:
            out = match_arrays(src, patterns[i], cfg, device=dev)
        results[i] = out


def match_patterns(src, patterns: Sequence[LearnedPattern],
                   cfg: Optional[MatchConfig] = None, device=None
                   ) -> List[Dict[str, np.ndarray]]:
    """Match G patterns against one source; returns one result-arrays dict
    per pattern, in input order, each equal to match_arrays of that
    pattern.

    The source pyramid is built once per call. Patterns are grouped by
    (pyramid shapes, flat-template flags, border color), which fix the
    plan; a group computes its sweep canvases once, and each pattern runs
    the rest of the pipeline on them. The JAX package warns when the
    patterns fall into many groups, because each group costs it one
    compile; eager PyTorch compiles nothing, and a group costs only its
    own sweep warp, so the port does not warn.
    """
    cfg = cfg or MatchConfig()
    dev = resolve_device(device)
    groups = _pattern_groups(patterns)
    if not groups:
        return []
    src, pyr = _source_pyramid(src, patterns, cfg, dev)
    results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(patterns)
    for idxs in groups.values():
        plan, packed = _match_group(pyr, src.shape,
                                    [patterns[i] for i in idxs], cfg, dev)
        _unpack_group(packed.cpu().numpy(), plan, src, patterns, idxs, cfg,
                      dev, results)
    return results
