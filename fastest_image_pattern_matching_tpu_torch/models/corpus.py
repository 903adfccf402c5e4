"""Corpus inspection: frames -> batched matcher -> one report per frame —
the port of fastest_image_pattern_matching_tpu/models/corpus.py.

Equal-shaped frames are batched through models/batch.py (the frames of a
batch share the pipeline's launches), or through the sharded matcher
(parallel/matcher.py) when a mesh is given; a frame of another shape ends
the current batch and starts its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, List, Optional

import numpy as np

from ..config import MatchConfig
from ..parallel.matcher import match_batch_sharded
from ..types import LearnedPattern, MatchResult
from ..utils.device import resolve_device
from ..utils.profiling import span
from .batch import _next_bucket, _results_from_arrays, match_many_arrays


@dataclasses.dataclass
class FrameReport:
    index: int
    results: List[MatchResult]
    execution_ms: float


def inspect_corpus(
    frames: Iterable[np.ndarray],
    pattern: LearnedPattern,
    cfg: Optional[MatchConfig] = None,
    mesh=None,
    batch_size: int = 8,
    device=None,
) -> Iterator[FrameReport]:
    """Yield a FrameReport per frame, in order.

    Equal-shaped frames are grouped into batches of batch_size, each
    matched as one batch: through parallel/matcher.py::match_batch_sharded
    on the mesh's device when a mesh is given (every rank of the mesh
    iterates the same frames and gets every report), through
    models/batch.py on `device` when not. An odd-shaped straggler forms
    its own (smaller) batch. A batch is matched as soon as it is full,
    and its reports are yielded before the next frame is pulled.
    execution_ms is the batch's wall time divided by its frames.
    """
    cfg = cfg or MatchConfig()
    dev = None if mesh is not None else resolve_device(device)
    buf: List[np.ndarray] = []
    idx: List[int] = []

    def flush() -> List[FrameReport]:
        with span("fipm.corpus.batch"):
            t0 = time.perf_counter()
            if mesh is not None:
                out = match_batch_sharded(np.stack(buf), pattern, cfg, mesh)
            else:
                out = match_many_arrays(
                    np.stack(buf), pattern, cfg,
                    batch_bucket=min(batch_size, _next_bucket(len(buf))),
                    device=dev)
            ms = (time.perf_counter() - t0) * 1000 / len(buf)
            reports = []
            for k, i in enumerate(idx):
                with span("fipm.results"):
                    reports.append(FrameReport(
                        i, _results_from_arrays(out, k, pattern), ms))
        buf.clear()
        idx.clear()
        return reports

    for i, frame in enumerate(frames):
        if buf and frame.shape != buf[0].shape:
            yield from flush()
        buf.append(frame)
        idx.append(i)
        # A full batch is matched now, not when the next frame arrives:
        # on a live camera that would hold its reports a frame period.
        if len(buf) >= batch_size:
            yield from flush()
    if buf:
        yield from flush()
