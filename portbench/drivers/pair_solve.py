"""Pair solves on one device (config3), as ``cli.py::_single_pair`` runs
one: the TSDFs of both depth images (``ops/tsdf.py::generate_tsdf_3d``),
``models/single_level.py::solve_single_level``, then the live field
resampled by the solved warp (``warp_field_cm``), the answer complete on the
card. A closed loop sends the traffic's pool of pairs round after round
(``lib/traffic.py::Rounds``) until the window ends.

The comparison: a sample of the finished pairs (``lib/sampling.py``) and the
one that took the most iterations, each solved again by the plain reference
from its depth images; the widest gaps of the TSDFs, the warp and the warped
live field, and the gap in iterations. The rate's halving compares two
energies, each a float32 sum over the volume; where they lie within rounding
of each other (``TIE``) either decision is sound, and the two sums' orders
differ. So where the reference's own solve fails the limits, its ``FLIPS``
closest such decisions are taken the other way in turn, closest first, and
the first solve within the limits, else the nearest, judges.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm

from portbench.drivers import common
from portbench.lib import peaks
from portbench.lib import traffic as gen
from portbench.lib.harness import Record
from portbench.lib.loop import closed_loop
from portbench.lib.sampling import Reservoir
from portbench.reference import solver as ref

SAMPLE = 1  # pairs drawn from the window, besides the longest
# The relative energy margin under which a halving decision can go either way:
# ten times the widest gap between the program's and the reference's relative
# energy changes, 1.05e-5 over config3's pool on an H100.
TIE = 1e-4
FLIPS = 6  # such decisions tried the other way


class Answer(NamedTuple):
    canonical: torch.Tensor
    live: torch.Tensor
    warp: torch.Tensor  # (3, X, Y, Z)
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
        self.longest = None  # (pool index, Answer)


def _pair(run, state, i: int) -> Answer:
    pair = state.pool[state.order(i)]
    with run.tracer.span("tsdf"):
        canonical = common.program_tsdf(run, state, pair.canonical)
        live = common.program_tsdf(run, state, pair.live)
    with run.tracer.span("solve"):
        res = solve_single_level(canonical, live, state.cfg.solver)
    with run.tracer.span("warp"):
        warp = to_component_major(res.warp)
        warped = warp_field_cm(live, warp)
        common.sync(run.device)
    return Answer(canonical, live, warp, warped, res.iterations)


def setup(run) -> State:
    state = State(run)
    _pair(run, state, 0)  # builds the kernels on a first run, warms every shape
    return state


def window(run, state: State) -> Record:
    def request(i):
        answer = _pair(run, state, i)
        key = state.order(i)
        state.sample.offer(key, answer)
        if state.longest is None or answer.iterations > state.longest[1].iterations:
            state.longest = (key, answer)
        return answer.iterations

    latencies, iterations, seconds = closed_loop(run, request)
    voxels = state.grid.num_voxels
    return Record(latencies, len(latencies), 0, seconds, iterations, voxels, 3,
                  peaks.b1_bytes(voxels), peaks.b2_bytes(voxels))


def _samples(state: State):
    """The compared pairs: pool index -> the program's answer."""
    chosen = dict(state.sample.items())
    if state.longest is not None:
        chosen[state.longest[0]] = state.longest[1]
    return chosen


def reference(run, state: State, key: int, dtype=torch.float32) -> Answer:
    """The plain reference's answer for pool pair ``key``, in ``dtype``."""
    pair = state.pool[key]
    canonical = common.reference_tsdf(run, pair.canonical, dtype)
    live = common.reference_tsdf(run, pair.live, dtype)
    sol = ref.solve(canonical, live, ref.params(run.cell.config["solver"], rounds=False),
                    dtype=dtype)
    return Answer(canonical, live, sol.warp, ref.resample(live, sol.warp), sol.iterations)


def compare(got: Answer, want: Answer) -> dict:
    return {
        "tsdf_gap": max(common.gap(got.canonical, want.canonical),
                        common.gap(got.live, want.live)),
        "warp_gap": common.gap(got.warp, want.warp),
        "warped_gap": common.gap(got.warped, want.warped),
        "iterations_gap": float(abs(got.iterations - want.iterations)),
    }


def judged(run, state: State, key: int, got: Answer):
    """(the numbers of ``got`` against the float32 reference of pool pair
    ``key``, the round whose halving decision that reference took the other
    way or None): its own solve, else its closest ties, as the module says."""
    pair = state.pool[key]
    canonical = common.reference_tsdf(run, pair.canonical)
    live = common.reference_tsdf(run, pair.live)
    p = ref.params(run.cell.config["solver"], rounds=False)
    sol = ref.solve(canonical, live, p)
    ties = sorted((m, r) for r, m in enumerate(sol.margins) if m < TIE)[:FLIPS]
    best = None
    for flip in [None] + [r for _, r in ties]:
        if flip is not None:
            sol = ref.solve(canonical, live, p, flip=flip)
        row = compare(got, Answer(canonical, live, sol.warp, ref.resample(live, sol.warp),
                                  sol.iterations))
        over = max(v / run.cell.limits[name] for name, v in row.items())
        if best is None or over < best[0]:
            best = (over, row, flip)
        if over <= 1.0:
            break
    return best[1], best[2]


def check(run, state: State, record: Record) -> list:
    chosen = _samples(state)
    state.sample = state.longest = None
    common.free(run.device)
    rows = []
    for key, answer in chosen.items():
        row, flip = judged(run, state, key, answer)
        rows.append(row)
        print(f"portbench: pair {key}: {answer.iterations} iterations, {row}, "
              f"reference flipped at round {flip}", file=sys.stderr)
    return common.worst(rows)


def control(run, dtype=torch.bfloat16) -> list:
    """The reference in ``dtype`` in the program's place on a seeded sample
    of the pool, judged as the program is."""
    state = State(run)
    keys = gen.rng(run.seed, 11).choice(len(state.pool), SAMPLE + 1, replace=False)
    return common.worst([judged(run, state, int(k), reference(run, state, int(k), dtype))[0]
                         for k in keys])
