"""The flat fusion of a depth sequence (config4), as ``cli.py::_multi_frame_3d``
runs it: one ``models/fusion.py::fuse_sequence`` call for the whole window,
``hierarchical=False``, warm-started frames, no checkpoints.

The traffic repeats one period of frames. With ``"source": "png"`` set-up
writes the period as 16-bit PNGs under the run's directory and the window
reads them through ``io/datasets.py::depth_directory``'s frame source (the
native ``DepthPrefetcher``) over a path list that repeats the period; with
``"source": "memory"`` the frames go in as numpy arrays. The iterator that
``fuse_sequence`` consumes stops at the deadline; a span around each of its
``next()`` calls on the frame source is the depth IO wait. A frame's latency
runs from the moment it is handed to ``fuse_sequence`` to its report.

The comparison follows the program frame by frame from its own state, since
a frame's answer depends on every frame before it: the start (frames 0 and 1)
from the depth images alone, then a sample of the window's frames and its
last, each from the program's state after the frame before (canonical,
weights, warm-start warp) and the frame's depth: the warp's widest gap and
the shares of voxels where the fused canonical or the weights differ. (Every
frame runs the 80-iteration cap, in the program and in the reference's
control alike, so the iterations separate nothing and are not compared.)
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import NamedTuple

import torch

from levelsetfusion_tpu_torch.io import datasets
from levelsetfusion_tpu_torch.models.fusion import FusionPipelineConfig, fuse_sequence

from portbench.drivers import common
from portbench.lib import peaks
from portbench.lib import traffic as gen
from portbench.lib.harness import Record
from portbench.lib.sampling import Reservoir
from portbench.reference import solver as ref

SAMPLE = 6  # frames drawn from the window, besides the start and the last
WARM_FRAMES = 3  # set-up's fusion: frame 0 and two solved frames
REPEATS = 400  # periods in the path list (far past any window)


class Frame(NamedTuple):
    """A fused frame t: the state after it and its iterations."""

    index: int
    canonical: torch.Tensor
    weights: torch.Tensor
    warp: torch.Tensor  # (X, Y, Z, 3)
    iterations: int


class State:
    def __init__(self, run):
        cfg = common.program_config(run.cell.config)
        self.mix = run.cell.traffic
        self.camera = common.program_camera(self.mix)
        self.pipeline = FusionPipelineConfig(
            grid=common.grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            generation_method=cfg.generation_method,
            hierarchical=bool(run.cell.config["hierarchical"]), solver=cfg.solver)
        self.raw = gen.generate(self.mix, run.seed)
        self.frames = [gen.metres(r, self.mix["depth_unit_m"]) for r in self.raw]
        self.paths = None
        if self.mix["source"] == "png":
            directory = f"{run.scratch}/sequence"
            gen.write_sequence(directory, self.raw, gen.camera(self.mix["camera"]))
            ds = datasets.depth_directory(directory)
            self.paths = ds._paths
            self.name, self.camera = ds.name, ds.camera
        self.sample = Reservoir(SAMPLE, run.seed)
        self.start = self.last = self.before_last = None

    def source(self, frames: int | None = None):
        """The frame source ``fuse_sequence`` consumes (``frames`` of them,
        else as many as any window takes)."""
        if self.paths is None:
            endless = itertools.cycle(self.frames)
            return endless if frames is None else list(itertools.islice(endless, frames))
        paths = self.paths * (REPEATS if frames is None else -(-frames // len(self.paths)))
        paths = paths if frames is None else paths[:frames]
        return datasets.SequenceDataset(self.name, self.camera, [], paths).frame_source()


def setup(run) -> State:
    state = State(run)
    source = state.source(WARM_FRAMES)
    try:
        fuse_sequence(source, state.camera, state.pipeline, device=run.device)
    finally:
        _close(source)
    common.sync(run.device)
    return state


def _close(source) -> None:
    close = getattr(source, "close", None)
    if close is not None:
        close()


def window(run, state: State) -> Record:
    tracer = run.tracer
    handed, latencies, iterations, waits = {}, [], [], []
    source = state.source()
    frames = iter(source)

    def feed():
        t = 0
        while t == 0 or time.perf_counter() < deadline:
            if t:
                tracer.tick(t - 1)  # frame t is request t - 1
            t0 = time.perf_counter()
            with tracer.span("next_frame"):
                depth = next(frames)
            handed[t] = time.perf_counter()
            waits.append(handed[t] - t0)
            yield depth
            t += 1
        tracer.close(t - 1)

    def on_frame(t, fused, warp, report=None, solver=None):
        latencies.append(time.perf_counter() - handed[t])
        iterations.append(report.solver_iterations)
        frame = Frame(t, fused.canonical, fused.weights, warp, report.solver_iterations)
        before, state.last = state.last, frame
        state.before_last = before
        if t == 1:
            state.start = frame
        elif before is not None:
            state.sample.offer(t, (before, frame))

    tracer.begin_window(run.seconds)
    start = time.perf_counter()
    deadline = start + run.seconds
    try:
        fuse_sequence(feed(), state.camera, state.pipeline, device=run.device,
                      frame_callback=on_frame)
        common.sync(run.device)
    finally:
        _close(source)
    seconds = time.perf_counter() - start
    voxels = state.pipeline.grid.num_voxels
    # Request i is frame i + 1 (frame 0 is the canonical's first state).
    attempted = len(handed) - 1
    return Record(latencies, attempted, attempted - len(latencies), seconds, iterations,
                  voxels, 3, peaks.b1_bytes(voxels), peaks.b2_bytes(voxels), io_wait_s=waits)


def _compared(state: State) -> dict:
    """t -> (the program's frame t - 1 or None for the start, its frame t)."""
    out = dict(state.sample.items())
    if state.start is not None:
        out[1] = (None, state.start)
    if state.last is not None and state.last.index >= 2:
        out[state.last.index] = (state.before_last, state.last)
    return out


def reference(run, state: State, t: int, before: Frame | None,
              dtype=torch.float32) -> Frame:
    """Frame t by the plain reference, in ``dtype``: from the depth images
    alone for the start (t = 1), else from the program's frame t - 1."""
    period = len(state.frames)

    def tsdf(k):
        return common.reference_tsdf(run, state.frames[k % period], dtype)

    if before is None:
        canonical, weights = ref.first_state(tsdf(0))
        initial = None
    else:
        canonical, weights = before.canonical.to(dtype), before.weights.to(dtype)
        initial = before.warp.movedim(-1, 0)
    live = tsdf(t)
    sol = ref.solve(canonical, live, ref.params(run.cell.config["solver"], rounds=False),
                    initial, dtype)
    fused, total = ref.blend(canonical, weights, ref.resample(live, sol.warp))
    return Frame(t, fused, total, sol.warp.movedim(0, -1), sol.iterations)


def compare(got: Frame, want: Frame) -> dict:
    """The warp's widest gap, and the shares of voxels whose fused TSDF
    (by more than ``common.FIELD_TOL``) or weight differs: a voxel at the
    band's edge, where |w| meets 1 - 1e-5, may count in one and not in the
    other by rounding alone, and then differs by up to a whole TSDF step."""
    return {
        "warp_gap": common.gap(got.warp, want.warp),
        "canonical_mismatch": common.mismatch(got.canonical, want.canonical,
                                              common.FIELD_TOL),
        "weights_mismatch": common.mismatch(got.weights, want.weights, 0.5),
    }


def check(run, state: State, record: Record) -> list:
    frames = _compared(state)
    state.sample = state.start = state.last = state.before_last = None
    common.free(run.device)
    rows = []
    for t, (before, frame) in sorted(frames.items()):
        rows.append(compare(frame, reference(run, state, t, before)))
        print(f"portbench: frame {t}: {frame.iterations} iterations, {rows[-1]}",
              file=sys.stderr)
    return common.worst(rows)


def control(run, dtype=torch.bfloat16, frames: int = 6) -> list:
    """The reference in ``dtype`` in the program's place on the start and
    the next frames, each from the float32 reference's frame before,
    judged as the program is."""
    state = State(run)
    rows, before = [], None
    for t in range(1, frames + 1):
        want = reference(run, state, t, before)
        rows.append(compare(reference(run, state, t, before, dtype), want))
        before = want
    return common.worst(rows)
