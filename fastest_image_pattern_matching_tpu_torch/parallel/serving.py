"""Data-parallel sharded serving paths beyond the NCC matcher — the port of
fastest_image_pattern_matching_tpu/parallel/serving.py, on
torch.distributed.

parallel/matcher.py shards the flagship NCC pipeline over a ('data',
'angle') mesh; the other serving entry points are data-parallel and shard
over the 'data' axis of a mesh (make_data_mesh: all ranks on 'data'):

  * orb_match_many_sharded: B sources against one ORB template; each rank
    detects the template's features (one detect) and matches its shard of
    the sources with the same RANSAC draws as orb_match_many (reference
    analogue: repeated interactive runs, ORBMatch/ORBFeatureMatcher.cpp:21).
  * match_patterns_sharded: G glyph patterns against one source (the OCR
    demo loop, MatchTool/MatchToolDlg.cpp:714-771), the glyph axis
    sharded, the source pyramid built once on each rank.

Every rank is called with the same arguments and returns every result.
Each item's computation is the unsharded one, so the outputs equal
orb_match_many's and match_patterns' item by item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import MatchConfig
from ..types import LearnedPattern
from .mesh import DATA_AXIS, Mesh, make_mesh


def make_data_mesh(ranks: Optional[Sequence[int]] = None,
                   device=None) -> Mesh:
    """A 1-D 'data' mesh over `ranks` (default: the whole world), i.e. a
    ('data', 'angle') mesh of shape (n, 1)."""
    if ranks is None:
        n = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    else:
        n = len(ranks)
    return make_mesh((n, 1), ranks, device)


def _data_block(n: int, mesh: Mesh):
    """(rows per rank, first row of this rank) for n items padded to a
    multiple of the data axis."""
    per = -(-n // mesh.shape[0])
    return per, mesh.index(DATA_AXIS) * per


def orb_match_many_sharded(sources, template, cfg=None, seed: int = 0,
                           physics_shift_mm: float = 8.0,
                           mesh: Optional[Mesh] = None):
    """orb_match_many sharded over the data axis: B padded to a multiple of
    it (zero frames, matched and dropped), each rank matches its shard
    against the template's features. Returns a list of B ORBResult equal
    to the unsharded path's."""
    from ..models.orb import ORBConfig, _gray, _orb_packed, \
        _result_from_packed
    cfg = cfg or ORBConfig()
    mesh = mesh or make_data_mesh()
    if torch.is_tensor(sources):
        sources = sources.detach().cpu().numpy()
    sources = _gray(sources, 4)
    template = _gray(template, 3)
    if sources.ndim != 3:
        raise ValueError(f"sources must be [B, H, W], got "
                         f"{tuple(sources.shape)}")
    B = sources.shape[0]
    per, lo = _data_block(B, mesh)
    mine = sources[lo:lo + per]
    if mine.shape[0] < per:
        mine = np.concatenate([mine, np.zeros(
            (per - mine.shape[0],) + sources.shape[1:], sources.dtype)])
    packed = _orb_packed(mine, template, cfg, seed, mesh.device)
    packed = mesh.all_gather(torch.from_numpy(packed), DATA_AXIS).numpy()
    return [_result_from_packed(packed[b], tuple(template.shape),
                                physics_shift_mm) for b in range(B)]


def match_patterns_sharded(src, patterns: Sequence[LearnedPattern],
                           cfg: Optional[MatchConfig] = None,
                           mesh: Optional[Mesh] = None
                           ) -> List[Dict[str, np.ndarray]]:
    """match_patterns with each group's glyph axis sharded over the data
    axis: the group padded to a multiple of it (repeating its first glyph;
    those results are dropped), each rank matching its glyphs against its
    own source pyramid. The NMS-cap rule (template_matcher.py::
    _finalized) is decided on the gathered flags, the same on every rank.
    Result dicts equal the unsharded path's."""
    from ..models.batch import _match_group, _pattern_groups, \
        _source_pyramid
    from ..models.template_matcher import _finalized
    cfg = cfg or MatchConfig()
    mesh = mesh or make_data_mesh()
    groups = _pattern_groups(patterns)
    if not groups:
        return []
    src_hw, pyr = _source_pyramid(src, patterns, cfg, mesh.device)
    results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(patterns)
    for idxs in groups.values():
        per, lo = _data_block(len(idxs), mesh)
        padded = idxs + [idxs[0]] * (per * mesh.shape[0] - len(idxs))
        plan, finalize = _match_group(
            pyr, src_hw, [patterns[i] for i in padded[lo:lo + per]], cfg,
            mesh.device)
        outs = _finalized(plan, lambda cap: mesh.all_gather(
            finalize(cap), DATA_AXIS))
        for i, out in zip(idxs, outs):
            results[i] = out
    return results
