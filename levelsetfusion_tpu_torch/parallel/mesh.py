"""Process groups for the voxel-block sharded solvers. Twin of
``levelsetfusion_tpu/parallel/mesh.py``, its 1D mesh.

A JAX mesh axis becomes a ``torch.distributed`` process group with one
process per rank: rank r holds rows ``[r n, (r + 1) n)`` of spatial axis 0,
``n = X / world``. The group is NCCL on CUDA and gloo on the CPU. A rank's
device is ``cuda:LOCAL_RANK`` under ``torchrun``, else ``cuda:rank`` modulo
the visible devices.

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


def block_rows(n: int, rank: int, world: int) -> tuple:
    """``(start, stop)`` of rank ``rank``'s rows of an axis of ``n`` rows
    split over ``world`` ranks; ``n`` must divide."""
    if n % world:
        raise ValueError(f"axis 0 ({n}) must divide over {world} devices")
    size = n // world
    return rank * size, (rank + 1) * size


def shard_field(field: torch.Tensor, group: Group, axis: int = 0) -> torch.Tensor:
    """This rank's block of a full field, on the group's device."""
    start, stop = block_rows(field.shape[axis], group.rank, group.world)
    return field.narrow(axis, start, stop - start).contiguous().to(group.device)


def gather_field(block: torch.Tensor, group: Group, axis: int = 0) -> torch.Tensor:
    """The full field from every rank's block (``all_gather``: every rank
    gets it; the tests and the CLI read rank 0's)."""
    if group.world == 1:
        return block
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(group.world)]
    dist.all_gather(parts, block)
    return torch.cat(parts, dim=axis)
