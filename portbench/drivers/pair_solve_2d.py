"""Pair solves of depth scanlines on one device (config1), as
``cli.py::_single_pair`` runs ``single_pair_2d``: the x–z TSDFs of both
scanlines (``ops/tsdf.py::generate_tsdf_2d``),
``models/single_level.py::solve_single_level``, then the live field
resampled by the solved warp (``warp_field_cm``), the answer complete on the
card. A closed loop sends the traffic's pool of pairs round after round
(``lib/traffic.py::Rounds``) until the window ends.

The comparison: a sample of the finished pairs (``lib/sampling.py``) and the
one that took the most iterations, each solved again by the plain 2D
reference (``reference/tsdf2d.py``, ``reference/solver2d.py``) from its
scanlines; the widest gaps of the TSDFs, the warp and the warped live field,
and the gap in iterations (``pair_solve.compare``). The rate is fixed, so
no decision of the solve but its stop turns on rounding.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from levelsetfusion_tpu_torch.core.camera import Camera2d
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d

from portbench.drivers import common
from portbench.drivers.pair_solve import SAMPLE, Answer, compare
from portbench.lib import peaks
from portbench.lib import traffic as gen
from portbench.lib.harness import Record
from portbench.lib.loop import closed_loop
from portbench.lib.sampling import Reservoir
from portbench.reference import solver2d as ref
from portbench.reference import tsdf2d as ref_tsdf


class ScanCamera(NamedTuple):
    """The synthetic scanline camera of a traffic file's ``camera``
    {width}: f = W / 2, principal point at the centre."""

    fx: float
    cx: float
    width: int


def scan_camera(spec: dict) -> ScanCamera:
    w = int(spec["width"])
    return ScanCamera(w / 2.0, w / 2.0, w)


class State:
    def __init__(self, run):
        self.cfg = common.program_config(run.cell.config)
        self.grid = common.grid(self.cfg)
        cam = scan_camera(run.cell.traffic["camera"])
        self.camera = Camera2d(fx=cam.fx, cx=cam.cx, image_width=cam.width)
        self.pool = gen.generate(run.cell.traffic, run.seed)
        self.order = gen.rounds(run.cell.traffic, run.seed, len(self.pool))
        self.sample = Reservoir(SAMPLE, run.seed)
        self.longest = None  # (pool index, Answer)


def _tsdf(run, state, row) -> torch.Tensor:
    return generate_tsdf_2d(torch.from_numpy(row).to(run.device), state.camera, state.grid,
                            narrow_band_width_voxels=state.cfg.narrow_band_width_voxels,
                            method=state.cfg.generation_method)


def _pair(run, state, i: int) -> Answer:
    pair = state.pool[state.order(i)]
    with run.tracer.span("tsdf"):
        canonical = _tsdf(run, state, pair.canonical)
        live = _tsdf(run, state, pair.live)
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
    # The 2D step (the gradient assembly and the update) takes B2's place in
    # the byte model.
    return Record(latencies, len(latencies), 0, seconds, iterations, voxels, 2,
                  peaks.b1_bytes(voxels, 2), peaks.b2_bytes(voxels, 2))


def reference(run, key: int, pool, dtype=torch.float32) -> Answer:
    """The plain reference's answer for pool pair ``key``, in ``dtype``."""
    config, pair = run.cell.config, pool[key]
    cam = scan_camera(run.cell.traffic["camera"])

    def tsdf(row):
        return ref_tsdf.generate(torch.from_numpy(row).to(run.device), cam,
                                 config["grid_shape"], config["voxel_size"],
                                 config["grid_offset"], config["narrow_band_width_voxels"], dtype)

    canonical, live = tsdf(pair.canonical), tsdf(pair.live)
    sol = ref.solve(canonical, live, ref.params(config["solver"]), dtype=dtype)
    return Answer(canonical, live, sol.warp, ref.resample(live, sol.warp), sol.iterations)


def _samples(state: State):
    """The compared pairs: pool index -> the program's answer."""
    chosen = dict(state.sample.items())
    if state.longest is not None:
        chosen[state.longest[0]] = state.longest[1]
    return chosen


def check(run, state: State, record: Record) -> list:
    chosen = _samples(state)
    state.sample = state.longest = None
    common.free(run.device)
    rows = []
    for key, answer in chosen.items():
        row = compare(answer, reference(run, key, state.pool))
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
