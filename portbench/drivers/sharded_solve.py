"""Pair solves split over ranks (config5): every rank makes the pair's two
TSDFs over the whole grid and keeps its block of x rows, as
``cli.py::_sharded_3d`` does, then
``parallel/sharded.py::solve_single_level_sharded`` (the 1D sync solver:
halo exchanges every iteration, a reduction and a host read every round)
and ``warp_field_sharded`` (the live block resampled through a halo). The
ranks join through ``parallel/mesh.py::init_group`` (torchrun's
environment). A closed loop over the traffic's pool, rank 0's clock ending
the window (``lib/loop.py``).

The comparison: a sample of the finished pairs (the same on every rank),
each solved again over the whole volume by the plain reference on every
rank, each rank comparing its own block; the widest gaps over the ranks.
(Every solve runs its 32 iterations, so the iterations are not compared.)
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch
import torch.distributed as dist

from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.parallel import (
    close_group,
    init_group,
    solve_single_level_sharded,
    warp_field_sharded,
)
from levelsetfusion_tpu_torch.parallel.mesh import shard_field

from portbench.drivers import common
from portbench.lib import peaks
from portbench.lib import traffic as gen
from portbench.lib.harness import Record
from portbench.lib.loop import closed_loop
from portbench.lib.sampling import Reservoir
from portbench.reference import solver as ref

SAMPLE = 2


class Answer(NamedTuple):
    canonical: torch.Tensor  # this rank's blocks
    live: torch.Tensor
    warp: torch.Tensor  # (3, n, Y, Z)
    warped: torch.Tensor
    iterations: int


class State:
    def __init__(self, run):
        self.cfg = common.program_config(run.cell.config)
        self.grid = common.grid(self.cfg)
        self.camera = common.program_camera(run.cell.traffic)
        self.pool = gen.generate(run.cell.traffic, run.seed)
        self.order = gen.rounds(run.cell.traffic, run.seed, len(self.pool))
        self.sample = Reservoir(SAMPLE, run.seed)
        self.group = None


def _pair(run, state: State, i: int) -> Answer:
    pair, group, cfg = state.pool[state.order(i)], state.group, state.cfg
    with run.tracer.span("tsdf"):
        canonical = shard_field(common.program_tsdf(run, state, pair.canonical), group)
        live = shard_field(common.program_tsdf(run, state, pair.live), group)
    with run.tracer.span("solve"):
        res = solve_single_level_sharded(canonical, live, cfg.solver, group=group,
                                         live_halo=cfg.live_halo)
    with run.tracer.span("warp"):
        warped = warp_field_sharded(live, res.warp, group, cfg.live_halo)
        common.sync(run.device)
    return Answer(canonical, live, to_component_major(res.warp), warped, res.iterations)


def setup(run) -> State:
    state = State(run)
    state.group = init_group(run.device)
    if state.group.world != run.world:
        raise RuntimeError(f"the group has {state.group.world} ranks, the cell {run.world}")
    _pair(run, state, 0)
    return state


def _agree(run):
    def agree(command):
        t = torch.tensor([int(command[0]), command[1]], dtype=torch.int64, device=run.device)
        dist.broadcast(t, src=0)
        go, trace = t.tolist()
        return bool(go), trace

    return agree


def window(run, state: State) -> Record:
    def request(i):
        answer = _pair(run, state, i)
        state.sample.offer(state.order(i), answer)
        return answer.iterations

    latencies, iterations, seconds = closed_loop(run, request, _agree(run))
    rows, plane = state.grid.shape[0] // run.world, state.grid.shape[1] * state.grid.shape[2]
    return Record(latencies, len(latencies), 0, seconds, iterations, state.grid.num_voxels, 3,
                  peaks.b1_bytes(rows * plane),
                  peaks.b2_block_bytes(rows, plane, run.rank, run.world,
                                       state.cfg.solver.stencil_halo))


def reference(run, pair, dtype=torch.float32) -> Answer:
    """The whole volume's answer by the plain reference, in ``dtype``."""
    canonical = common.reference_tsdf(run, pair.canonical, dtype)
    live = common.reference_tsdf(run, pair.live, dtype)
    sol = ref.solve(canonical, live, ref.params(run.cell.config["solver"], rounds=True),
                    dtype=dtype)
    return Answer(canonical, live, sol.warp, ref.resample(live, sol.warp), sol.iterations)


def compare(got: Answer, want: Answer, rows: slice) -> dict:
    """A rank's block ``rows`` of the program's answer against the whole
    reference."""
    return {
        "tsdf_gap": max(common.gap(got.canonical, want.canonical[rows]),
                        common.gap(got.live, want.live[rows])),
        "warp_gap": common.gap(got.warp, want.warp[:, rows]),
        "warped_gap": common.gap(got.warped, want.warped[rows]),
    }


def check(run, state: State, record: Record) -> list:
    chosen = dict(state.sample.items())
    state.sample = None
    common.free(run.device)
    n = state.grid.shape[0] // run.world
    rows = slice(run.rank * n, (run.rank + 1) * n)
    found = []
    for key, answer in chosen.items():
        want = reference(run, state.pool[key])
        found.append(compare(answer, want, rows))
        print(f"portbench: rank {run.rank} pair {key}: {answer.iterations} iterations, "
              f"{found[-1]}", file=sys.stderr)
        del want
        common.free(run.device)
    names, values = zip(*common.worst(found))
    t = torch.tensor(values, dtype=torch.float64, device=run.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    close_group(state.group)
    return list(zip(names, t.tolist()))


def control(run, dtype=torch.bfloat16) -> list:
    """The reference in ``dtype`` in the program's place on a seeded sample
    of the pool, over the whole volume on one device, judged as the
    program is."""
    pool = gen.generate(run.cell.traffic, run.seed)
    keys = gen.rng(run.seed, 11).choice(len(pool), SAMPLE, replace=False)
    rows = []
    for key in keys:
        got = reference(run, pool[key], dtype)
        rows.append(compare(got, reference(run, pool[key]), slice(None)))
        del got
        common.free(run.device)
    return common.worst(rows)
