"""Coarse-to-fine pair solves of depth scanlines on one device (config2), as
``cli.py::_hierarchical_2d`` runs ``hierarchical_2d`` with
``pyramid_method="ewa_depth"``:
``models/hierarchical.py::solve_hierarchical_from_depth`` on both
scanlines (each pyramid's coarse levels EWA TSDFs of the depth on coarsened
grids, its finest a BASIC one; each level solved in ``loop_for``'s kept
loop of its shape from the coarser level's warp, prolongated), then the
live field's BASIC TSDF at the finest grid, as the CLI makes it, resampled
by the finest warp (``warp_field_cm``), the answer complete on the card. A
closed loop sends the traffic's pool of pairs round after round
(``lib/traffic.py::Rounds``) until the window ends.

The comparison: a sample of the finished pairs (``lib/sampling.py``) and the
one that took the most iterations over its levels, each solved again by the
plain hierarchical reference (``reference/hier2d.py``) from its scanlines;
the widest gaps of the TSDFs (the finest live field the window warped, and
the six fields of both pyramids: the program's pyramids of those scanlines
made again, once the window is over, by ``build_pyramid_from_depth``, the
function the solve calls), the finest warp and the warped live field, and
the widest gap in a level's iterations. The rate is fixed, so no decision
of the solve but a level's stop turns on rounding.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, NamedTuple

import torch

from levelsetfusion_tpu_torch.core.camera import Camera2d
from levelsetfusion_tpu_torch.models.hierarchical import (
    build_pyramid_from_depth,
    solve_hierarchical_from_depth,
)
from levelsetfusion_tpu_torch.models.params import HierarchicalParams
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d

from portbench.drivers import common
from portbench.drivers.pair_solve import SAMPLE, _samples
from portbench.drivers.pair_solve_2d import scan_camera
from portbench.lib import peaks
from portbench.lib import traffic as gen
from portbench.lib.harness import Record
from portbench.lib.loop import closed_loop
from portbench.lib.sampling import Reservoir
from portbench.reference import hier2d as ref


@dataclasses.dataclass
class HierRecord(Record):
    """``Record`` with each request's iterations a level (coarsest first;
    ``iterations`` holds their sum) and each level's voxels."""

    level_iterations: List[List[int]] = dataclasses.field(default_factory=list)
    level_voxels: List[int] = dataclasses.field(default_factory=list)


class Answer(NamedTuple):
    canonical: List[torch.Tensor]  # the pyramids, finest first
    live: List[torch.Tensor]
    field: torch.Tensor  # the finest live field that ``warped`` resamples
    warp: torch.Tensor  # (2, X, Z), the finest level's
    warped: torch.Tensor
    iterations: List[int]  # a level's, coarsest first


def level_voxels(grid, levels: int) -> List[int]:
    """Each level's voxels, coarsest first."""
    out = [grid.num_voxels]
    for _ in range(levels - 1):
        grid = grid.coarsened(2)
        out.insert(0, grid.num_voxels)
    return out


class State:
    def __init__(self, run):
        self.cfg = common.program_config(run.cell.config)
        self.grid = common.grid(self.cfg)
        self.params = HierarchicalParams(levels=self.cfg.levels, base=self.cfg.solver)
        cam = scan_camera(run.cell.traffic["camera"])
        self.camera = Camera2d(fx=cam.fx, cx=cam.cx, image_width=cam.width)
        self.pool = gen.generate(run.cell.traffic, run.seed)
        self.order = gen.rounds(run.cell.traffic, run.seed, len(self.pool))
        self.sample = Reservoir(SAMPLE, run.seed)
        self.longest = None  # (pool index, Answer)


def _pair(run, state, i: int) -> Answer:
    pair = state.pool[state.order(i)]
    canonical_depth = torch.from_numpy(pair.canonical).to(run.device)
    live_depth = torch.from_numpy(pair.live).to(run.device)
    nb = state.cfg.narrow_band_width_voxels
    with run.tracer.span("hier"):
        res = solve_hierarchical_from_depth(canonical_depth, live_depth, state.camera,
                                            state.grid, state.params,
                                            narrow_band_width_voxels=nb)
    with run.tracer.span("warp"):
        live = generate_tsdf_2d(live_depth, state.camera, state.grid,
                                narrow_band_width_voxels=nb,
                                method=state.cfg.generation_method)
        warp = to_component_major(res.warp)
        warped = warp_field_cm(live, warp)
        common.sync(run.device)
    return Answer([], [], live, warp, warped, [r.iterations for r in res.level_results])


def setup(run) -> State:
    state = State(run)
    _pair(run, state, 0)  # builds the kernels on a first run, warms every level's loop
    return state


def window(run, state: State) -> HierRecord:
    levels = []

    def request(i):
        answer = _pair(run, state, i)
        key = state.order(i)
        state.sample.offer(key, answer)
        if state.longest is None or sum(answer.iterations) > sum(state.longest[1].iterations):
            state.longest = (key, answer)
        levels.append(answer.iterations)
        return sum(answer.iterations)

    latencies, iterations, seconds = closed_loop(run, request)
    voxels = state.grid.num_voxels
    # The 2D step takes B2's place in the byte model, at the finest level
    # here; ``level_voxels`` gives each level's.
    return HierRecord(latencies, len(latencies), 0, seconds, iterations, voxels, 2,
                      peaks.b1_bytes(voxels, 2), peaks.b2_bytes(voxels, 2),
                      level_iterations=levels,
                      level_voxels=level_voxels(state.grid, state.params.levels))


def pyramids(run, state: State, key: int):
    """The program's (canonical, live) pyramids of pool pair ``key``, finest
    first, made again by the function the solve calls."""
    pair, nb = state.pool[key], state.cfg.narrow_band_width_voxels
    out = []
    for row in (pair.canonical, pair.live):
        fields, _ = build_pyramid_from_depth(torch.from_numpy(row).to(run.device),
                                             state.camera, state.grid, state.params.levels, nb)
        out.append(fields[::-1])
    return out


def reference(run, key: int, pool, dtype=torch.float32) -> Answer:
    """The plain reference's answer for pool pair ``key``, in ``dtype``."""
    config, pair = run.cell.config, pool[key]
    grids = ref.levels(config["grid_shape"], config["voxel_size"], config["grid_offset"],
                       config["narrow_band_width_voxels"], config["levels"])
    sol = ref.solve(torch.from_numpy(pair.canonical).to(run.device),
                    torch.from_numpy(pair.live).to(run.device),
                    scan_camera(run.cell.traffic["camera"]), grids,
                    ref.params(config["solver"]), dtype=dtype)
    return Answer(sol.canonical, sol.live, sol.live[0], sol.warp, sol.warped, sol.iterations)


def compare(got: Answer, want: Answer) -> dict:
    fields = [(got.field, want.field)] + list(zip(got.canonical + got.live,
                                                  want.canonical + want.live))
    return {
        "tsdf_gap": max(common.gap(a, b) for a, b in fields),
        "warp_gap": common.gap(got.warp, want.warp),
        "warped_gap": common.gap(got.warped, want.warped),
        "iterations_gap": float(max(abs(a - b) for a, b in zip(got.iterations, want.iterations))),
    }


def check(run, state: State, record: Record) -> list:
    chosen = _samples(state)
    state.sample = state.longest = None
    common.free(run.device)
    rows = []
    for key, answer in chosen.items():
        canonical, live = pyramids(run, state, key)
        row = compare(answer._replace(canonical=canonical, live=live),
                      reference(run, key, state.pool))
        rows.append(row)
        print(f"portbench: pair {key}: {answer.iterations} iterations, {row}", file=sys.stderr)
    return common.worst(rows)


def control(run, dtype=torch.bfloat16) -> list:
    """The reference in ``dtype`` in the program's place on a seeded sample
    of the pool, judged against the float32 reference as the program is."""
    pool = gen.generate(run.cell.traffic, run.seed)
    keys = gen.rng(run.seed, 11).choice(len(pool), SAMPLE + 1, replace=False)
    return common.worst([compare(reference(run, int(k), pool, dtype),
                                 reference(run, int(k), pool)) for k in keys])
