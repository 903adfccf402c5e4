"""Multi-target peak extraction (GetNextMaxLoc semantics, batched).

The reference takes the global max of a score map, paints a suppression
rectangle of 2W(1-overlap) x 2H(1-overlap) around it with -1 and repeats
(MatchTool/MatchToolDlg.cpp:1558-1582), optionally with its s_BlockMax block
cache (:1583-1596). The row-major first-max tie-break of cv::minMaxLoc is
torch.argmax's documented first-max rule, a NaN counting as the greatest.

Maps on the card go to the hand-written kernel (ops/cuda/peaks_kernel.py,
csrc/peaks.cu), which runs every round on the card in one of two forms
picked by the map's size: a small map lives in one block's shared memory
for all k rounds (one launch, e.g. the flagship's 41 top-layer maps); a
large one keeps a tile-max cache, the JAX package's _extract_peaks_tiled
form, and re-scans only the tiles each rectangle touches (two launches,
e.g. Test7's one 1798x1798 map). Maps on the CPU take the plain version,
extract_peaks_ref: each of the k rounds is one batched argmax over
[A, H*W] plus a masked fill. Both give the same peaks bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import span
from .cuda import peaks_kernel
from .rounding import f32


def extract_peaks(
    scores: torch.Tensor,       # [A, Hs, Ws] f32 (invalid regions pre-masked to -1)
    k: int,                     # peaks per map = max_pos + MATCH_CANDIDATE_NUM
    templ_wh: Tuple[int, int],  # template (w, h) at this layer
    max_overlap: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy masked top-k per score map.

    Returns (vals [A, k] f32, locs [A, k, 2] int32 as (x, y)); threshold
    filtering is left to the caller.
    """
    tw, th = templ_wh
    # cv::rectangle fills the inclusive range [x0, x0 + sw - 1]; the int
    # casts truncate toward zero like C.
    sw = int(2 * tw * (1 - max_overlap))
    sh = int(2 * th * (1 - max_overlap))
    off_x = f32(tw * (1.0 - max_overlap))
    off_y = f32(th * (1.0 - max_overlap))
    with span("fipm.peaks"):
        if scores.is_cuda:
            return peaks_kernel.extract_peaks_cuda(scores, k, sw, sh, off_x,
                                                   off_y)
        return extract_peaks_ref(scores, k, sw, sh, off_x, off_y)


def extract_peaks_ref(scores: torch.Tensor, k: int, sw: int, sh: int,
                      off_x: float, off_y: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: k rounds of a batched argmax and a masked fill of
    the sw x sh rectangle at (trunc(x - off_x), trunc(y - off_y)), in f32.
    What the kernel must compute; the path of CPU tensors."""
    A, Hs, Ws = scores.shape
    dev = scores.device
    xs = torch.arange(Ws, dtype=torch.int32, device=dev)[None, None, :]
    ys = torch.arange(Hs, dtype=torch.int32, device=dev)[None, :, None]
    maps = scores.clone()
    flat = maps.view(A, Hs * Ws)
    rows = torch.arange(A, device=dev)
    vals, locs = [], []
    for _ in range(k):
        with span("fipm.peaks.round"):
            idx = torch.argmax(flat, dim=1)
            v = flat[rows, idx]
            y = (idx // Ws).to(torch.int32)
            x = (idx % Ws).to(torch.int32)
            vals.append(v)
            locs.append(torch.stack([x, y], dim=-1))
            x0 = torch.trunc(x.to(torch.float32) - off_x).to(torch.int32)
            y0 = torch.trunc(y.to(torch.float32) - off_y).to(torch.int32)
            x0 = x0[:, None, None]
            y0 = y0[:, None, None]
            in_rect = (((xs >= x0) & (xs <= x0 + sw - 1))
                       & ((ys >= y0) & (ys <= y0 + sh - 1)))
            maps.masked_fill_(in_rect, -1.0)
    return torch.stack(vals, dim=1), torch.stack(locs, dim=1)
