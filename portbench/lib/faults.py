"""Faults planted under the timed path of a cell on several chips, each run
as the cell's ranks in processes of their own: the fault tests drive them on
the CPU at a small size, ``calibrate.py --fault`` on the card at the cell's
size, and ``correct`` has to come out false for each.

- ``exchange``: the halo exchange left out; every rank fills its halos as
  at the volume's edges and sends nothing;
- ``state``: B2 returns the warp unchanged;
- ``answer``: the warped live field altered by +0.1 where it is made;
- ``none``: nothing planted (the sound run beside them).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Callable, List

import torch

FAULTS = ("none", "exchange", "state", "answer")


def frozen_step(warped, canonical, warp_cm, rate, *, out=None, **kw):
    """A B2 step that returns its state unchanged (and reports no update)."""
    n = warp_cm.shape[1] if kw.get("x_len") is None else kw["x_len"]
    lo = kw.get("x_lo", 0)
    new = warp_cm[:, lo:lo + n].clone()
    if out is not None:
        out.copy_(new)
        new = out
    return new, torch.zeros(8, dtype=warp_cm.dtype, device=warp_cm.device)


def shifted(fn, by):
    """``fn`` with ``by`` added to its answer."""
    def altered(*args, **kw):
        return fn(*args, **kw) + by
    return altered


def no_exchange(x, width, group, fill="replicate", axis=0, wait=True):
    """The halo as at the volume's edges on every rank: nothing sent."""
    from levelsetfusion_tpu_torch.parallel import halo
    from levelsetfusion_tpu_torch.parallel.mesh import MeshAxis

    return halo.halo_exchange(x, width, MeshAxis(0, 1, 0, 1, None), fill=fill, axis=axis,
                              wait=wait)


def plant(fault: str) -> None:
    """Plant ``fault`` in this process's program and driver."""
    import levelsetfusion_tpu_torch.parallel.sharded as program_sharded
    from portbench.drivers import sharded_solve

    if fault == "exchange":
        program_sharded.halo_exchange = no_exchange
    elif fault == "state":
        program_sharded.fused_gradient_update = frozen_step
    elif fault == "answer":
        sharded_solve.warp_field_sharded = shifted(sharded_solve.warp_field_sharded, 0.1)
    elif fault != "none":
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")


def _rank(rank, world, port, fault, make_cell, run_args, device, queue):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
        torch.set_num_threads(1)
    from portbench.lib import harness

    plant(fault)
    res = harness.run_rank(make_cell(), harness.parse(run_args), rank, world, time.time(),
                           device=device)
    queue.put((rank, res))


def run_ranks(make_cell: Callable, run_args: List[str], world: int, fault: str,
              device: str | None = None, timeout_s: float = 1150.0) -> List[dict]:
    """One run of a cell on ``world`` ranks with ``fault`` planted in each;
    the ranks' results in rank order. ``make_cell`` (picklable) gives the
    cell in each rank; ``device`` None puts rank r on ``cuda:r``."""
    from portbench.lib.ranks import free_port

    ctx = mp.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_rank,
                         args=(r, world, port, fault, make_cell, run_args, device, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=timeout_s) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
