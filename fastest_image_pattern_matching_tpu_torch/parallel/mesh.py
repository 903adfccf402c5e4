"""Process meshes for sharded matching over torch.distributed — the port of
fastest_image_pattern_matching_tpu/parallel/mesh.py.

One process per device (one GPU each under NCCL, or CPU processes under
gloo). A mesh lays the world's ranks out as a 2-D grid with axes
('data', 'angle'): frames are sharded over 'data', the top-layer angle
sweep and the candidate descent over 'angle'. Every rank creates the
process group of every row and column of the grid, in the same order, as
torch.distributed requires, and keeps the two that hold it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
ANGLE_AXIS = "angle"


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the process group (torch.distributed.init_process_group), once
    per process before make_mesh().

    world_size and rank default to torchrun's WORLD_SIZE and RANK; the
    backend to NCCL when there is a card and gloo on the CPU; init_method
    to "env://" (MASTER_ADDR / MASTER_PORT). A world of one with no
    init_method is a no-op, as the JAX package's is on a single host: the
    mesh's collectives are then identities. timeout bounds every
    collective (torch's default when None)."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        if world_size <= 1:
            return
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D grid of ranks with axes ('data', 'angle') and this rank's
    place in it.

    grid: [nd, na] global ranks; coords: (data index, angle index) of this
    rank; groups: this rank's process group along each axis (None when no
    process group is initialised: a world of one, whose collectives are
    identities); device: where this rank computes."""
    grid: np.ndarray
    coords: Tuple[int, int]
    groups: Tuple[Optional[object], Optional[object]]
    device: torch.device

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.grid.shape)

    def members(self, axis: str) -> Sequence[int]:
        """The global ranks of this rank's group along `axis`, in mesh
        order."""
        di, ai = self.coords
        if axis == DATA_AXIS:
            return [int(r) for r in self.grid[:, ai]]
        return [int(r) for r in self.grid[di, :]]

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == DATA_AXIS else 1]

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's x along `axis`, concatenated on `dim` in mesh
        order. Every rank of the group must call it with the same shape
        and dtype. Gloo gathers on the CPU, NCCL on the card; bool goes as
        u8. The result lies on x's device."""
        group = self.groups[0 if axis == DATA_AXIS else 1]
        if group is None:
            return x
        members = self.members(axis)
        comm_dev = (torch.device("cpu") if dist.get_backend(group) == "gloo"
                    else self.device)
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        y = y.to(comm_dev).contiguous()
        parts = [torch.empty_like(y) for _ in members]
        dist.all_gather(parts, y, group=group)
        # all_gather returns group-rank order, which is ascending global
        # rank; put the parts in mesh order.
        by_rank = dict(zip(sorted(members), parts))
        out = torch.cat([by_rank[r] for r in members], dim=dim).to(x.device)
        return out.to(torch.bool) if x.dtype == torch.bool else out


def _default_shape(n: int) -> Tuple[int, int]:
    """More ranks on the angle axis (the sweep and the descent are the
    parallel work of one large image); two rows from four ranks up, as
    the JAX package factorises its devices."""
    d = 2 if n >= 4 and n % 2 == 0 else 1
    return d, n // d


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              ranks: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """Build a ('data', 'angle') mesh over `ranks` (default: the whole
    world), laid out row-major. Every process of the world must call it
    with the same shape and ranks. Batch serving should pass an explicit
    shape like (n, 1).

    device: where this rank computes; default cuda:LOCAL_RANK (raising
    without a card). CPU processes under gloo pass "cpu"."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    me = dist.get_rank() if initialised else 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {world}")
    n = len(ranks)
    shape = _default_shape(n) if shape is None else tuple(int(s)
                                                          for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's ranks {ranks}")
    grid = np.array(ranks, dtype=np.int64).reshape(shape)
    di, ai = (int(v[0]) for v in np.nonzero(grid == me))
    groups = [None, None]
    if initialised:
        # Every rank creates every group, in one order (new_group is
        # collective over the world).
        for j in range(shape[1]):
            g = dist.new_group([int(r) for r in grid[:, j]])
            if j == ai:
                groups[0] = g
        for i in range(shape[0]):
            g = dist.new_group([int(r) for r in grid[i, :]])
            if i == di:
                groups[1] = g
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return Mesh(grid=grid, coords=(di, ai), groups=tuple(groups),
                device=resolve_device(device))
