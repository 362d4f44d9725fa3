"""Process groups for the voxel-block sharded solvers. Twin of
``levelsetfusion_tpu/parallel/mesh.py``: its 1D mesh and ``make_mesh_2d``.

A JAX mesh axis becomes a ``torch.distributed`` process group with one
process per rank: on the 1D mesh (``Group``) rank r holds rows ``[r n, (r +
1) n)`` of spatial axis 0, ``n = X / world``. On the 2D mesh (``Mesh2D``,
``make_mesh_2d``) of shape ``(s0, s1)``, rank ``r = i0 s1 + i1`` holds the
block of rows ``[i0 n0, (i0 + 1) n0)`` and columns ``[i1 n1, (i1 + 1) n1)``;
each mesh axis is a ``MeshAxis``: this rank's coordinate along it, the
global-rank stride to its neighbours and the process group of its line of
ranks (one ``dist.new_group`` for each mesh row and column). The group is
NCCL on CUDA and gloo on the CPU. A rank's device is ``cuda:LOCAL_RANK``
under ``torchrun``, else ``cuda:rank`` modulo the visible devices.

``init_group`` joins the default group when one is up, or makes it:

- under ``torchrun`` (``WORLD_SIZE`` in the environment) through ``env://``;
- with ``store_path``, ``rank`` and ``world`` through a ``FileStore`` at
  that path (the CPU tests' spawned ranks: no TCP port);
- else as a world of 1 in this process, on a ``HashStore``, so that a run
  needs no launcher.

JAX's ``solve_single_level_auto`` (GSPMD) has no counterpart here.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class Group(NamedTuple):
    """This process's place in the 1D group: ``rank`` of ``world``, the
    device its blocks live on, and whether ``init_group`` made the default
    group (``close_group`` then takes it down)."""

    rank: int
    world: int
    device: torch.device
    owned: bool = False


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_group(device="cuda", *, store_path: str | None = None, rank: int | None = None,
               world: int | None = None, timeout_s: float = 300.0) -> Group:
    """Join or make the default process group for blocks on ``device`` (see
    the module docstring); returns this process's ``Group``."""
    device = torch.device(device)
    owned = False
    if not dist.is_initialized():
        from datetime import timedelta

        timeout = timedelta(seconds=timeout_s)
        if store_path is None and "WORLD_SIZE" in os.environ:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            device = _rank_device(device, rank)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(backend_for(device), init_method="env://",
                                    rank=rank, world_size=world, timeout=timeout)
        else:
            if store_path is None:
                store, rank, world = dist.HashStore(), 0, 1
            else:
                store = dist.FileStore(store_path, world)
            device = _rank_device(device, rank)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(backend_for(device), store=store, rank=rank,
                                    world_size=world, timeout=timeout)
        owned = True
    rank, world = dist.get_rank(), dist.get_world_size()
    return Group(rank, world, _rank_device(device, rank), owned)


def close_group(group: Group) -> None:
    """Take the default group down if ``init_group`` made it for ``group``."""
    if group.owned and dist.is_initialized():
        dist.destroy_process_group()


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: its coordinate ``index`` of
    ``size``, its global ``rank``, the global-rank ``stride`` between two
    neighbours along the axis, and the process group of the ranks along the
    axis that share this rank's other coordinate (None: the default group,
    which is that line when the mesh is 1D)."""

    index: int
    size: int
    rank: int
    stride: int
    group: object = None

    def peer(self, k: int) -> int | None:
        """The global rank ``k`` steps along the axis (None past the
        ends)."""
        return self.rank + k * self.stride if 0 <= self.index + k < self.size else None


class Mesh2D(NamedTuple):
    """This process's place in a 2D mesh over the default group: the world's
    ``Group``, the mesh's ``shape`` ``(s0, s1)`` and its two ``axes``
    (``MeshAxis``; axis 0 splits spatial axis 0, axis 1 spatial axis 1)."""

    group: Group
    shape: tuple
    axes: tuple

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world


def line(group) -> MeshAxis:
    """A ``Group`` as the one axis of its 1D mesh (a ``MeshAxis`` as it
    is)."""
    if isinstance(group, MeshAxis):
        return group
    return MeshAxis(group.rank, group.world, group.rank, 1, None)


def make_mesh_2d(group: Group, shape) -> Mesh2D:
    """The ``(s0, s1)`` mesh over the world of ``group``, which must hold
    ``s0 * s1`` ranks. Every rank calls it (each makes every row's and
    column's process group, in the same order)."""
    s0, s1 = (int(v) for v in shape)
    if s0 < 1 or s1 < 1 or s0 * s1 != group.world:
        raise ValueError(f"need {s0 * s1} devices, have {group.world}")
    i0, i1 = divmod(group.rank, s1)
    lines = {}
    for axis, (n, other) in enumerate(((s0, s1), (s1, s0))):
        for j in range(other):
            ranks = [k * s1 + j if axis == 0 else j * s1 + k for k in range(n)]
            pg = dist.new_group(ranks) if 1 < n < group.world else None
            lines[axis, j] = pg
    axes = (MeshAxis(i0, s0, group.rank, s1, lines[0, i1]),
            MeshAxis(i1, s1, group.rank, 1, lines[1, i0]))
    return Mesh2D(group, (s0, s1), axes)


def block_rows(n: int, rank: int, world: int) -> tuple:
    """``(start, stop)`` of rank ``rank``'s rows of an axis of ``n`` rows
    split over ``world`` ranks; ``n`` must divide."""
    if n % world:
        raise ValueError(f"axis 0 ({n}) must divide over {world} devices")
    size = n // world
    return rank * size, (rank + 1) * size


def block_index(shape, mesh, rank: int | None = None) -> tuple:
    """Rank ``rank``'s (default this rank's) ``(start, stop)`` along each
    axis of a field of ``shape`` on ``mesh`` (a ``Group``: blocks of axis 0;
    a ``Mesh2D``: of axes 0 and 1), the whole extent along the others."""
    rank = mesh.rank if rank is None else rank
    if isinstance(mesh, Mesh2D):
        coords = divmod(rank, mesh.shape[1])
        cuts = [block_rows(shape[a], coords[a], mesh.shape[a]) for a in (0, 1)]
    else:
        cuts = [block_rows(shape[0], rank, mesh.world)]
    return (*cuts, *((0, n) for n in shape[len(cuts):]))


def full_shape(block_shape, mesh) -> tuple:
    """The whole field's shape from a rank's block of ``block_shape``."""
    split = mesh.shape if isinstance(mesh, Mesh2D) else (mesh.world,)
    return (*(n * s for n, s in zip(block_shape, split)), *block_shape[len(split):])


def shard_field(field: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """This rank's block of a full field, on the group's device: rows of
    ``axis`` on a ``Group``, rows and columns on a ``Mesh2D``."""
    if isinstance(group, Mesh2D):
        for a, (start, stop) in enumerate(block_index(field.shape, group)[:2]):
            field = field.narrow(a, start, stop - start)
        return field.contiguous().to(group.device)
    start, stop = block_rows(field.shape[axis], group.rank, group.world)
    return field.narrow(axis, start, stop - start).contiguous().to(group.device)


def gather_field(block: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """The full field from every rank's block (``all_gather``: every rank
    gets it; the tests and the CLI read rank 0's). On a ``Mesh2D`` the
    blocks are of axes 0 and 1."""
    if group.world == 1:
        return block
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(group.world)]
    dist.all_gather(parts, block)
    if isinstance(group, Mesh2D):
        s1 = group.shape[1]
        rows = [torch.cat(parts[i * s1:(i + 1) * s1], dim=1) for i in range(group.shape[0])]
        return torch.cat(rows, dim=0)
    return torch.cat(parts, dim=axis)
