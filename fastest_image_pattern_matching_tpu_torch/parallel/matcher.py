"""Sharded batch matching over a ('data', 'angle') mesh of processes — the
port of fastest_image_pattern_matching_tpu/parallel/matcher.py, on
torch.distributed.

Every rank is called with the same full batch and returns the full result,
as the JAX package's multi-process path does. Each rank runs the stages of
the single-device pipeline (models/template_matcher.py::build_stages) on
its part, with collectives between them:

  its data shard of frames, its block of the angle list:
      sweep_maps -> all_gather(peaks) over 'angle'          ([Bl, A, K] x 3)
  select_candidates (replicated within the angle group) -> strided
      candidate shard -> descent of C/na candidates a frame
      -> all_gather(survivors) over 'angle'                 ([Bl*C] x 5)
  finalize (NMS) on every rank of the angle group
      -> all_gather(packed results) over 'data'             ([Bl, mp+1, 13])

Every rank calls every collective the same number of times with equal
shapes: frames are padded to a multiple of the data axis (zero frames,
computed and dropped), angles to a multiple of the angle axis (maps of
valid extent 0, whose scores are all -1), candidates to a multiple of the
angle axis (dead ones), and the NMS-cap rule of template_matcher.py::
_finalized is decided on the gathered flags, which every rank holds.

Exactness against the unsharded path: a candidate's descent does not
depend on the candidates it shares a chunk with (the descent's correlation
and subpixel fit run in f64), finalize orders candidates by value with a
position tie-break, and cfg.narrow_candidates keeps each frame's GLOBAL
top scorers (a gather and a value-keyed mask, through build_stages'
narrow_hook) instead of each rank's local ones. So the partition does not
change the result.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import MatchConfig
from ..ops.pyramid import build_pyramid
from ..types import LearnedPattern
from ..models.template_matcher import (_by_frame, _check_sizes,
                                       _finalized, _frames, _pack_result,
                                       _plan_inputs, _rows, _stacked,
                                       build_stages, narrow_bound, narrowed,
                                       upload_frames)
from .mesh import ANGLE_AXIS, DATA_AXIS, Mesh, make_mesh


def _pad_rows(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """x padded along dim 0 to n rows of `fill`."""
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def _sharded_candidates(mesh: Mesh, plan, stats, frames, templs, inv_l,
                        valid_l, trans_p, angles_p):
    """This rank's part of the pipeline up to finalize, on its frames
    [Bl, H, W] and its angle block. Returns the stage functions and the
    descended candidates of its frames, C a frame, gathered over the
    angle group (the same on every rank of the group)."""
    na = mesh.shape[1]
    ai = mesh.index(ANGLE_AXIS)
    n_frames = frames.shape[0]
    C = plan.c_max
    Cl = -(-C // na)
    Cp = Cl * na
    cl = narrow_bound(plan.cfg.max_pos)

    def narrow_hook(ptLT, ang, score, alive, fidx):
        """Keep each frame's global top-cl candidates (template_matcher.py::
        narrowed) over every rank of the angle group (the unsharded path's
        kept set); dropped candidates stay in place, dead."""
        if Cp <= cl:
            return alive
        g = [mesh.all_gather(x, ANGLE_AXIS)
             for x in (ptLT, ang, score, alive, fidx)]
        keep = torch.zeros_like(g[3])
        keep[narrowed(g, n_frames, cl)] = True
        n = alive.shape[0]
        return alive & keep[ai * n:(ai + 1) * n]

    st = build_stages(plan, stats, mesh.device, narrow_hook=narrow_hook)
    pyr = build_pyramid(st.prep_src(frames), plan.top)
    vals, locs = st.sweep_maps(pyr[plan.top], templs[plan.top], inv_l,
                               valid_l)
    vals = mesh.all_gather(vals, ANGLE_AXIS, dim=1)
    locs = mesh.all_gather(locs, ANGLE_AXIS, dim=1)
    pt, ang, score, alive = st.select_candidates(vals, locs, trans_p,
                                                 angles_p)

    def shard_c(x, fill):
        """[Bl, C, ...] -> this rank's [Bl, Cl, ...]: candidates ai,
        ai + na, ... (select_candidates sorts by score, so the stride
        spreads the alive ones evenly)."""
        x = _pad_rows(x.transpose(0, 1), Cp, fill).transpose(0, 1)
        return x[:, ai::na]

    cands = st.descend(pyr, templs, shard_c(pt, 0.0), shard_c(ang, 0.0),
                       shard_c(score, -1.0), shard_c(alive, False))
    g = [mesh.all_gather(x, ANGLE_AXIS) for x in cands]
    grp = _by_frame(g[4], n_frames)
    if Cp > C:
        # C candidates a frame, as unsharded: the alive ones and enough
        # dead ones (the padding among them) to fill.
        o = torch.sort((~g[3][grp]).to(torch.int8), dim=1,
                       stable=True).indices[:, :C]
        grp = _rows(grp, o)
    sel = grp.reshape(-1)
    return st, tuple(x[sel] for x in g)


def match_batch_sharded(
    srcs,                              # [B, H, W] u8, the same on every rank
    pattern: LearnedPattern,
    cfg: Optional[MatchConfig] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Match one template against a batch of frames, sharded over the
    mesh; every rank of the mesh calls it with the same arguments.

    B is padded to a multiple of the 'data' axis, the angle list to a
    multiple of the 'angle' axis (padded angles are fully masked and give
    no candidates). Returns stacked result arrays [B, max_pos, ...] (the
    keys of models/batch.py::match_many_arrays) on every rank, each frame
    equal to its unsharded result."""
    cfg = cfg or MatchConfig()
    mesh = mesh or make_mesh()
    if torch.is_tensor(srcs):
        srcs = srcs.detach().cpu().numpy()
    srcs = _frames(srcs)
    _check_sizes(pattern, srcs.shape[1:])
    B = srcs.shape[0]
    nd, na = mesh.shape
    di, ai = mesh.coords
    dev = mesh.device
    plan, stats, (templs, inv_mats, trans, valid_wh, angles_arr) = \
        _plan_inputs(srcs.shape[1:], pattern, cfg, dev)

    Al = -(-inv_mats.shape[0] // na)
    inv_p, trans_p, valid_p, angles_p = (
        _pad_rows(x, Al * na) for x in (inv_mats, trans, valid_wh,
                                        angles_arr))
    inv_l = inv_p[ai * Al:(ai + 1) * Al].contiguous()
    valid_l = valid_p[ai * Al:(ai + 1) * Al]

    Bl = -(-B // nd)
    frames = srcs[di * Bl:(di + 1) * Bl]
    if frames.shape[0] < Bl:
        frames = np.concatenate([frames, np.zeros(
            (Bl - frames.shape[0],) + srcs.shape[1:], srcs.dtype)])
    frames = upload_frames(frames, dev)

    st, cands = _sharded_candidates(mesh, plan, stats, frames, templs, inv_l,
                                    valid_l, trans_p, angles_p)
    # finalize on this rank's frames, gathered over the data group: every
    # rank holds the same flags, so all take _finalized's second pass
    # together.
    return _stacked(_finalized(plan, lambda cap: mesh.all_gather(
        _pack_result(st.finalize(*cands, Bl, cap), cfg.max_pos),
        DATA_AXIS)[:B]))
