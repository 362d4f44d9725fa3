"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            (from the root of the repository)

Builds every CUDA kernel of the port from ``levelsetfusion_tpu_torch/csrc``
(one nvcc per source, all at once; phase 1), holds B1 and B2 against their
plain torch versions on the card (2, 3), the 2D step at every 2D shape of
the main path, timed (3b), and the solve loop's tail at config1's and
config3's stats, timed in a CUDA graph against a stated limit (3c), checks
a small kernel solve against the plain solve on the CPU (4), holds the solve's graph loop (16 iterations
a CUDA graph replay, the done flag on the device) to the eager loop that
reads the flag every iteration at 128³, exactly, and prints the graph's
memory (4b), runs the config3 preset (128³, full energy) through
``cli.run_experiment`` with the kernels' launch counters reset just before
(5: the serial loop's iteration count; each replay adds to the counters
the calls its capture recorded, which must be 16 of each kernel), and times the
rate cell through both loops in turns, a frozen iteration, and each kernel
against its plain version (6: the fused gradient at 256³ too, and a
``torch.profiler`` breakdown of each loop: device time per kernel,
device-busy time and the host gap). Then it drives the port's experiment
entry points (``levelsetfusion_tpu_torch.experiments``: mxu_conv,
fused_io_probe, dma_probe, fused_ablation, fused_gradient_bench,
resample_variants, v10_xslab, bisect_kernel, loop_cost; phases 7-15), each
with its kernels' launch counters reset just before and read just after,
and holds their kernels against their plain versions. Last, config4: the
fusion at (32, 32, 24) x 4 frames on the card against the plain fusion on
the CPU, and its pipelined loop against its serial loop (16); and config4
at 128³ x 8 frames through ``cli.run_experiment``, this slice's main path,
with the launch counters reset just before, its checks, frames/s and a
stop after frame 4's checkpoint resumed to the uninterrupted run's state,
and the host seconds of its checkpoint saves beside its wall time (17).
Then the slice of configs 1-2, rigid and the hierarchical fusion, each run
with the launch counters reset just before and read just after: config1
(2D) through the CLI against the CPU run, its 2D step launches (also as
``summary.json`` reports them), and its 2D
graph loop against the eager loop, exactly, both timed with a profiler
breakdown (18); config2 through the CLI with its EWA depth pyramid and its
block-mean one against the CPU (19); rigid_2d and rigid_3d through the CLI
against the CPU and the truth, and their 30 steps under CUDA's sync debug
mode (20); the hierarchical fusion at (32, 32, 24) x 4 frames against the
CPU, at 128³ x 8 frames with its checks, graph captures, launches and
frames/s beside the flat path's, and the EWA TSDF methods at 128³ against
the CPU, timed (21). Then the 1D sharded solver (config5) and the
kernels' sharded arguments: B1 with ``x_start`` and B2 with its x window on
every rank's haloed block of a 4-way split of 128³, an 8-way split of
config5_512's 512³ and the worlds of 1 that phases 23 and 24 run (512³,
(128, 64, 128), 128³), each against its plain version and the union of the
windows against the whole-volume call, timed at the (74, 512, 512) shard
(22); ``sharded_3d`` through ``cli.run_experiment`` on a world of 1 (NCCL),
config5_sharded against the single-device port and config5_512 at 512³
with its µs/iter, peak memory and a profiler breakdown, and on 2 NCCL
ranks against 1 where the process sees two devices (23); the sharded
fusion at 128³ x 8 frames against ``fuse_sequence``, and each frame with no
live halo against the single-device frame by phase 16's rules (24), each
run with the launch counters reset just before. Then the other sharded
solvers: B2's y window on every block of config5_2dmesh's (2, 4) split and
of 512³ on (2, 4), and ``conv_local_x`` on every rank of 512³ / 8, each
against its plain version and the whole call, timed at the 512³ shard
(25); config5_2dmesh, config5_sharded_schur, config5_schur2d and
config5_hierarchical through ``cli.run_experiment`` on a world of 1 (a
(1, 1) mesh) against the single-device port, and config5_512's problem
through the 2D-mesh solver, timed with a profiler breakdown beside phase
23's (26); the hierarchical and the 2D-mesh sharded fusion at 128³ x 8
frames against ``fuse_sequence`` (27). Then the last modules: config4
read from a ``depth_directory`` of 16-bit PNGs through
``cli.run_experiment`` at 128³ x 8 frames, the decoder that ran, equal to
the in-memory fusion of the decoded frames, its launches, frames/s from disk
and from memory in turns, the device's busy share and a stop-and-resume
(28); the multi-device dry run (``dryrun.py``) on a world of 1, and on 2
NCCL ranks where two devices are seen (29); config1 through ``cli.main``
with ``--verbose``, ``--profile`` and ``--check-nans``, ``validate_solve``
and ``nan_checks`` on a diverging rate against the CPU, and
``advect_field`` against the CPU (30), each run with the launch counters
reset just before where it launches kernels. The kernels line's launches
sum the main paths' (config3, config4, config1, config2, the hierarchical
fusion, config5_sharded, config5_512, the sharded fusion, those of phases
26–27, config4 from disk and the dry run), and B1's and B2's rows give
their windowed times at the shard (B2 also its y window's and
conv_local_x's).
Beside each kernel it times, where one exists, one PyTorch call that
computes the same function (the kernel's yardstick; the port never calls
it), and it computes each kernel's bound from the run's tensors. Every
phase prints at least one line and raises on failure. The line before the
last is a JSON object describing the kernels; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it fails before printing any
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch import cli, dryrun
from levelsetfusion_tpu_torch.cli import _grid, _pair_2d, _pair_3d, run_experiment
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.experiments import (
    _sweep,
    bisect_kernel,
    dma_probe,
    fused_ablation,
    fused_gradient_bench,
    fused_io_probe,
    loop_cost,
    mxu_conv,
    resample_variants,
    v10_xslab,
)
from levelsetfusion_tpu_torch.experiments._timing import SPIN_CYCLES, best_ms
from levelsetfusion_tpu_torch.io import datasets, depth, native_loader, synthetic
from levelsetfusion_tpu_torch.models import fusion, single_level
from levelsetfusion_tpu_torch.models.hierarchical import solve_hierarchical
from levelsetfusion_tpu_torch.models.params import HierarchicalParams, SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.models.rigid import solve_rigid_2d, solve_rigid_3d
from levelsetfusion_tpu_torch.models.single_level import (
    CHECK_EVERY,
    SolveLoop,
    release_kept_loops,
    solve_single_level,
)
from levelsetfusion_tpu_torch.ops import pyramid
from levelsetfusion_tpu_torch.ops.interpolation import advect_field, warp_field
from levelsetfusion_tpu_torch.ops.kernels import _lib, fused_gradient, loop_tail, resample, step2d
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    fused_gradient_update_reference,
    sobolev_taps,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import (
    warp_field_cm,
    warp_field_cm_reference,
)
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod, generate_tsdf_2d, generate_tsdf_3d
from levelsetfusion_tpu_torch.parallel import (
    close_group,
    init_group,
    make_mesh_2d,
    solve_hierarchical_sharded,
    solve_single_level_schur,
    solve_single_level_schur2d,
    solve_single_level_sharded,
    solve_single_level_sharded2d,
    warp_field_sharded,
)
from levelsetfusion_tpu_torch.utils import checkpoint
from levelsetfusion_tpu_torch.utils.config import PRESETS
from levelsetfusion_tpu_torch.utils.debug import NonFiniteError, nan_checks, validate_solve

PRESET = "config3_3d_full_energy"
FULL = (128, 128, 128)
RAGGED = (37, 50, 61)
CONFIG1 = (96, 48)  # config1's 2D grid (utils/config.py)
CONFIG2_LEVELS = ((24, 16), (48, 32), (96, 64))  # config2's 3 levels of (96, 64)
HIER_LEVELS = ((32, 32, 32), (64, 64, 64))  # the hierarchical fusion's coarse levels of 128³
STREAM_ROUNDS = 20
# B2's tiles are 8 x 32 (terms) and 16 x 32 (update) (y, z) columns: shapes
# that straddle them (z over many tiles with a ragged tail, an extent of 1),
# config5's per-shard shape, z 16 tiles wide, and the hierarchical fusion's
# coarse levels.
B2_SHAPES = (FULL, RAGGED, (9, 33, 300), (1, 6, 130), (64, 512, 512), *HIER_LEVELS)
BIG = (256, 256, 256)  # g (201 MB) no longer fits the 50 MB L2
PROFILE_ITERS = 2 * CHECK_EVERY  # two replays of the graph loop, no frozen iteration
# Phase 4b's cases on config3's inputs: the preset (converges mid-chunk), a
# cap that is not a multiple of CHECK_EVERY, and a rate that halves.
LOOP_CASES = (("config3", {}),
              ("cap37", dict(max_iterations=37, convergence_threshold=0.0)),
              ("halving", dict(max_iterations=40, convergence_threshold=0.0,
                               learning_rate=5.0)))
SERIAL = dict(check_every=1, graph=False)  # the eager loop reading the flag every iteration
C4 = "config4_3d_fusion"
# tests/test_fusion.py::_small_sequence_config: its sequence, grid and solver.
C4_SMALL_SEQ = dict(num_frames=4, width=48, height=48, blob_radius_px=10.0, blob_height=0.05,
                    drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1)
C4_SMALL = fusion.FusionPipelineConfig(
    grid=GridSpec(shape=(32, 32, 24), voxel_size=0.008, offset=(-16, -16, 42)),
    hierarchical=False,
    solver=SolverParams(max_iterations=60, learning_rate=0.5, smoothing_term_weight=0.1,
                        convergence_threshold=2e-3, smoothing_mode=SmoothingMode.KILLING,
                        adaptive_learning_rate=True))
C4_STOP = 4  # the resume check stops the run after this frame's checkpoint
C4_SMALL_HIER = dataclasses.replace(C4_SMALL, hierarchical=True)  # 3 levels
C1, C2 = "config1_2d_pair", "config2_2d_hierarchical"
RIGID = ("rigid_2d", "rigid_3d")
EWA = (GenerationMethod.EWA_IMAGE, GenerationMethod.EWA_TSDF, GenerationMethod.EWA_TSDF_INCLUSIVE)
# tests/test_fused_gradient.py CASES: (w_smooth, w_ls, killing, sobolev, band_union)
CASES = [
    (0.2, 0.0, False, False, True),
    (0.2, 0.1, True, False, True),
    (0.1, 0.1, True, True, True),
    (0.2, 0.1, False, True, False),
    (0.0, 0.0, False, False, True),
]
BENCH_ITERS = 300  # bench.py's N_ITER
MAIN_LIBRARIES = ("resample", "fused_gradient", "step2d", "loop_tail")  # the main paths' kernels
LIBRARIES = (*MAIN_LIBRARIES, "conv_yz", "fused_io_probe", "dma_probe",
             "resample_variants", "v10_xslab", "stack_bodies")
RAGGED_X = (20, 64, 128)  # a ragged x for the resample variants (their Z is 128)
RAGGED_B3 = (5, 6, 128)  # a Y off the 8-row tiles of B3-B5 (yb = Y): their runtime geometry
B45_VARIANTS = ("vf_fori", "vf_chunk", "vf_unroll", "v7_chunk", "v7_unroll")
B4_WINDOW = ("vf_fori_yb6", "vf_chunk_yb6", "vf_unroll_yb6")  # B4 at RAGGED_B3
B5_WINDOW = ("v7_chunk_yb6", "v7_unroll_yb6")  # B5 at RAGGED_B3

# The card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores (every bound below counts f32 work).
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Float operations per voxel (an add, sub, mul, min, max, abs or floor
# counts one) that the function needs, whatever a kernel's design spends.
OPS_RESAMPLE = 43  # trilinear at v + u: 3 adds, 3 floors, 6 subs; 8 corners x (3 muls, 1 add) - 1
OPS_CLAMPED_RESAMPLE = OPS_RESAMPLE + 4  # ux, uy clamped to ±K first (B3-B8)
OPS_FUSED = 270  # B2's function, rounded: Sobolev 3 x 3 x 7 x 2, terms ~130, update 14
OPS_B9_FULL = 1 + 2 * 35 + 3  # floor; the sums of the 36 z0c and z1c values; 2 weights, 1 add
OPS_CONV_YZ = 2 * (2 * 7 - 1)  # the 7-tap y and z passes, 7 muls and 6 adds a tap row


def _fields(shape, seed, warp_scale, device="cuda"):
    """TSDF-like canonical and warped fields and a (3, *shape) warp, as the
    JAX package's fused-gradient tests build them."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.4)
    warped = np.tanh(np.roll(base, 1, axis=0) * 0.4)
    warp = (rng.standard_normal((3,) + shape) * warp_scale).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (canonical, warped, warp)]


def _close(name, got, want, rtol, atol=0.0):
    err = torch.abs(got.double() - want.double())
    bound = atol + rtol * torch.abs(want.double())
    if not bool(torch.all(err <= bound)):
        worst = float(torch.max(err - bound))
        raise AssertionError(f"{name}: exceeds rtol={rtol} atol={atol} by {worst:.3e}")
    return float(torch.max(err)) if err.numel() else 0.0


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the f32 operations over the card's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _numbers(launches, err, ms, plain_ms, bound, library_ms):
    """The measured fields of a kernel row."""
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


def _grid_sample(volume, pos):
    """One ``F.grid_sample`` call that samples ``volume`` (B, D, H, W) at
    the index positions ``pos`` (B, D', H', W', 3), given in (d, h, w)
    order: trilinear, +1 outside, as zero padding of volume - 1, plus 1.
    Returns the call (the part a yardstick times) and the function that
    turns its result into the value."""
    sizes = torch.tensor(volume.shape[1:], dtype=pos.dtype, device=pos.device)
    grid = (pos * (2.0 / (sizes - 1)) - 1.0).flip(-1).contiguous()
    shifted = (volume - 1.0)[:, None].contiguous()

    def call():
        return F.grid_sample(shifted, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    return call, lambda out: out[:, 0] + 1.0


def _field_grid_sample(field, warp_cl):
    """The yardstick of the field resample at v + u(v) (B1, B3-B6), for a
    channel-last warp: ``(call, value)`` with ``value(call())`` (X, Y, Z)."""
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=field.device) for s in field.shape),
        indexing="ij"), dim=-1)
    call, value = _grid_sample(field[None], (idx + warp_cl)[None])
    return call, lambda out: value(out)[0]


def _stack_grid_sample(stacked, warp):
    """The yardstick of the stack bodies that resample (B8 level 4, B7): the
    stack as a batch over y of (plane, padded x, z) volumes, sampled at
    (K + uy, x + K + ux, z + uz), ux and uy clamped; ``value(call())`` is
    (X, Y, 128)."""
    k = loop_cost.K
    ux, uy, uz = resample_variants.clamp_warp(warp).unbind(-1)
    x = torch.arange(warp.shape[0], dtype=torch.float32, device=warp.device)[:, None, None]
    z = torch.arange(warp.shape[2], dtype=torch.float32, device=warp.device)
    pos = torch.stack([k + uy, x + k + ux, z + uz], dim=-1)  # (X, Y, Z, 3)
    call, value = _grid_sample(stacked.permute(2, 0, 1, 3), pos.permute(1, 0, 2, 3)[:, None])
    return call, lambda out: value(out)[:, 0].permute(1, 0, 2)


def _stack_bytes(warp):
    """Bytes a stack body must move: the stack rows it reads (X + 5 of each
    plane), the warp, and the output."""
    nx, ny, nz, _ = warp.shape
    vox = nx * ny * nz
    return 4 * (loop_cost.N * (nx + loop_cost.N - 1) * ny * nz + 4 * vox)


def _time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, CUDA events, after a warm-up. A
    spin of about 100 us a call is queued before the start event, so that
    the host has enqueued the calls by the time the device reaches them
    (where a call takes the host less) and the events time the device's
    work."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES * reps // 10)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase0_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(line)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    return line


def phase1_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        native = pool.submit(native_loader.build)  # the depth-IO library (g++), beside nvcc
        list(pool.map(_lib.build, LIBRARIES))
        native.result()
    seconds = time.perf_counter() - t0
    parts = [f"{name}: {', '.join(_ptxas(name))}" for name in MAIN_LIBRARIES]
    print(f"[1] build of {len(LIBRARIES)} CUDA libraries and the depth-IO library: "
          f"{seconds:.1f} s; ptxas, registers r / "
          f"spill bytes B / stack frame bytes B / static shared S: {'; '.join(parts)}")


B1_SHAPES = (FULL, RAGGED, CONFIG1, *CONFIG2_LEVELS, *HIER_LEVELS)


def phase2_resample():
    """B1 is bit-exact with its plain version at every shape the main paths
    give it: 128^3 (config3, config4 and its finest level), RAGGED (Z = 61,
    a ragged last z tile), config1's and config2's 2D grids (run as (X, 1,
    Z)) and the hierarchical fusion's coarse levels, with |u| up to 6
    voxels, so that many corners read outside."""
    worst = 0.0
    for seed, shape in enumerate(B1_SHAPES, 1):
        rng = np.random.default_rng(seed)
        live = torch.from_numpy(
            np.tanh(rng.standard_normal(shape).astype(np.float32))
        ).cuda()
        warp = torch.from_numpy(
            rng.uniform(-6.0, 6.0, (len(shape),) + shape).astype(np.float32)
        ).cuda()
        got = warp_field_cm(live, warp)
        torch.cuda.synchronize()
        want = warp_field_cm_reference(live, warp)
        worst = max(worst, _close(f"resample {shape}", got, want, 0.0, 0.0))
    print(f"[2] resample vs plain at {B1_SHAPES}, |u| <= 6: "
          f"max|Δ| {worst} (exact)")
    return worst


def _case_kw(w_smooth, w_ls, killing, sob, band):
    return dict(w_data=1.0, w_smooth=w_smooth, w_ls=w_ls, killing=killing, gamma=0.1,
                band_union=band, taps=sobolev_taps(7, 0.1) if sob else ())


def _check_fused(case, got, want, rtol=2e-5, atol=2e-5):
    """B2's output against its plain version: the sums within rel 1e-4, the
    maxes within rel 1e-5, the warp within ``rtol``/``atol`` (phase 3's
    2e-5/2e-5 by default); returns the warp's max|Δ|."""
    (got_w, got_s), (want_w, want_s) = got, want
    _close(case + " sums", got_s[:4], want_s[:4], 1e-4)
    _close(case + " maxes", got_s[4:], want_s[4:], 1e-5)
    return _close(case + " warp", got_w, want_w, rtol, atol)


def phase3_fused():
    worst = 0.0
    for seed, shape in enumerate(B2_SHAPES, 3):
        canonical, warped, warp = _fields(shape, seed, 0.8)
        rate = torch.tensor(0.3, device="cuda")
        for case in CASES:
            kw = _case_kw(*case)
            got = fused_gradient_update(warped, canonical, warp, rate, **kw)
            torch.cuda.synchronize()
            want = fused_gradient_update_reference(warped, canonical, warp, rate, **kw)
            worst = max(worst, _check_fused(f"fused {shape} case {case}", got, want))
    print(f"[3] fused gradient vs plain, 5 cases at {B2_SHAPES}: "
          f"warp max|Δ| {worst:.3e} (rtol/atol 2e-5; sums rtol 1e-4, maxes rtol 1e-5)")
    worst = max(worst, _two_streams())
    _second_device()
    return worst


def _two_streams():
    """Two same-shape B2 calls enqueued on two CUDA streams, STREAM_ROUNDS
    rounds: each call counts its completion on its own stream's ticket, so
    each one's warp and stats equal its plain version's."""
    kw = _case_kw(*CASES[2])
    worst = 0.0
    for shape in (RAGGED, FULL):
        inputs = [_fields(shape, seed, 0.8) for seed in (11, 12)]
        rate = torch.tensor(0.3, device="cuda")
        wants = [fused_gradient_update_reference(w, c, u, rate, **kw) for c, w, u in inputs]
        streams = [torch.cuda.Stream() for _ in inputs]
        torch.cuda.synchronize()
        for r in range(STREAM_ROUNDS):
            outs = []
            for stream, (c, w, u) in zip(streams, inputs):
                with torch.cuda.stream(stream):
                    outs.append(fused_gradient_update(w, c, u, rate, **kw))
            torch.cuda.synchronize()
            for i, (got, want) in enumerate(zip(outs, wants)):
                worst = max(worst, _check_fused(f"fused {shape} stream {i} round {r}", got,
                                                want))
    print(f"[3] fused gradient, two same-shape calls on two streams, {STREAM_ROUNDS} rounds "
          f"at {RAGGED} and {FULL}: each held to its plain version, warp max|Δ| {worst:.3e}")
    return worst


def _second_device():
    """One B2 case on device 1 where the process sees one, after B2 ran on
    device 0: the kernels' shared memory opt-in and occupancy are asked for
    per device. B1 and v10, whose grids use the same per-device cache, run
    there too."""
    if torch.cuda.device_count() < 2:
        print(f"[3] C2's second device was not exercised: this process sees "
              f"{torch.cuda.device_count()} device")
        return
    device = torch.device("cuda", 1)
    canonical, warped, warp = _fields(FULL, 13, 0.8, device)
    rate = torch.tensor(0.3, device=device)
    kw = _case_kw(*CASES[2])
    got = fused_gradient_update(warped, canonical, warp, rate, **kw)
    torch.cuda.synchronize(device)
    want = fused_gradient_update_reference(warped, canonical, warp, rate, **kw)
    err = _check_fused(f"fused {FULL} on {device}", got, want)
    b1 = _close(f"resample {FULL} on {device}", warp_field_cm(warped, warp),
                warp_field_cm_reference(warped, warp), 0.0, 0.0)
    field, warps = v10_xslab.inputs(FULL, device)
    v10 = _close(f"v10 {FULL} on {device}", v10_xslab.run_v10(field, warps[0][2]),
                 v10_xslab.run_v10_reference(field, warps[0][2]), 0.0, 1e-5)
    print(f"[3] on {device} ({torch.cuda.get_device_name(device)}): fused gradient warp "
          f"max|Δ| {err:.3e}, resample {b1}, v10 {v10:.3e}")


# The 2D step's shapes: config1's grid, config2's three levels (Sobolev on in
# the preset) and a ragged one (8 x 16 tiles with ragged last tiles).
STEP2D_SHAPES = (CONFIG1, *CONFIG2_LEVELS, (37, 23))
STEP2D_WARP_TOL = 4.768e-7  # B2's standard, for the new warp and the per-voxel maxes
STEP2D_SUM_RTOL = 1e-5  # the kernel sums in double, the plain version in f32 in another order
# Float operations per voxel of the 2D step, rounded: bilinear at v + u 17
# (2 adds, 2 floors, 2 subs; 4 corners x (2 muls, 1 add) - 1), the terms
# ~100, the 7-tap Sobolev 2 x 2 x 7 x 2, the update and its stats ~10.
OPS_STEP2D = 180


def _step2d_inputs(shape, seed):
    """(live, canonical, warp_cm, rate) on the card: TSDF-like fields
    truncated to exactly ±1 on a share of voxels (so that the band-union
    mask bites), and a warp that reaches out of the grid at its faces."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.clip(base * 0.8, -1.0, 1.0)
    live = np.clip(np.roll(base, 2, axis=0) * 0.8, -1.0, 1.0)
    warp = rng.standard_normal((2, *shape)).astype(np.float32)
    return (*(torch.from_numpy(a).cuda() for a in (live, canonical, warp)),
            torch.tensor(0.5, device="cuda"))


def _graph_us(fn, calls=16, reps=50):
    """µs a call of ``fn`` replayed in a CUDA graph of ``calls`` calls, as
    the solve loop runs the 2D step: the best of two runs of ``reps``
    replays by CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    best = None
    for _ in range(2):
        ms = _time_ms(graph.replay, reps)
        best = ms if best is None else min(best, ms)
    return best * 1e3 / calls


def phase3b_step2d():
    """The 2D step (``step2d``, one launch a 2D iteration) against its plain
    version on the card at every 2D shape of the main path, over phase 3's
    five term sets (data only, Tikhonov, Killing with the level set, with
    and without Sobolev and the band-union mask): the new warp and the
    per-voxel maxes within 4.768e-7, the energies and Σ‖δu‖ within rtol
    1e-5; a call with the flag off writes nothing and leaves the ticket at
    0. Then config1's and config2's finest step timed by CUDA events, alone
    after a spin, in a CUDA graph as the loop replays it, and its plain
    version. Returns (max|Δ|, launches, ms, plain ms, bound) at config1."""
    worst = {"warp": 0.0, "maxes": 0.0, "sums": 0.0}
    step2d.launch_count = 0
    calls = 0
    for seed, shape in enumerate(STEP2D_SHAPES, 21):
        live, canonical, warp, rate = _step2d_inputs(shape, seed)
        flag = torch.tensor(True, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        for case in CASES:
            kw = _case_kw(*case)
            out = torch.full_like(warp, 7.0)
            got, stats = step2d.step2d(live, canonical, warp, rate, out=out, active=flag,
                                       ticket=ticket, **kw)
            calls += 1
            torch.cuda.synchronize()
            want, want_stats = step2d.step2d_reference(*(a.cpu() for a in (live, canonical,
                                                                           warp, rate)), **kw)
            name = f"step2d {shape} case {case}"
            if got is not out or int(ticket) != 0:
                raise AssertionError(f"{name}: out not written in place or ticket {int(ticket)}")
            worst["warp"] = max(worst["warp"],
                                _close(name + " warp", got.cpu(), want, 0.0, STEP2D_WARP_TOL))
            worst["maxes"] = max(worst["maxes"], _close(name + " maxes", stats[4:].cpu(),
                                                        want_stats[4:], 0.0, STEP2D_WARP_TOL))
            _close(name + " sums", stats[:4].cpu(), want_stats[:4], STEP2D_SUM_RTOL, 1e-7)
            worst["sums"] = max(worst["sums"], float(torch.max(
                torch.abs(stats[:4].cpu().double() - want_stats[:4].double())
                / torch.clamp(torch.abs(want_stats[:4].double()), min=1e-30))))
        out, stats = torch.full_like(warp, 7.0), torch.full((7,), 3.0, device="cuda")
        step2d.step2d(live, canonical, warp, rate, out=out, stats=stats, ticket=ticket,
                      active=torch.tensor(False, device="cuda"), **_case_kw(*CASES[2]))
        calls += 1
        torch.cuda.synchronize()
        if not (bool((out == 7.0).all()) and bool((stats == 3.0).all()) and int(ticket) == 0):
            raise AssertionError(f"step2d {shape}: a call with the flag off wrote its buffers")
    if step2d.launch_count != calls:
        raise AssertionError(f"step2d: {step2d.launch_count} launches counted for {calls} calls")
    lines, row = [], None
    for preset, shape in ((C1, CONFIG1), (C2, PRESETS[C2].grid_shape)):
        kw = single_level.fused_step_kwargs(PRESETS[preset].solver)
        live, canonical, warp, rate = _step2d_inputs(shape, 1)
        flag = torch.tensor(True, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        partial = torch.zeros(max(step2d.partial_len(shape, len(kw["taps"]), "cuda"), 1),
                              dtype=torch.float64, device="cuda")
        out, stats = torch.empty_like(warp), torch.empty(7, device="cuda")

        def call():
            step2d.step2d(live, canonical, warp, rate, out=out, stats=stats, active=flag,
                          ticket=ticket, partial=partial, **kw)

        def plain():
            step2d.step2d_reference(live, canonical, warp, rate, out=out, stats=stats, **kw)

        # Plain, kernel, kernel, plain: in turns within one call.
        p_ms = [_time_ms(plain, 10)]
        k_ms = [_time_ms(call, 200) for _ in range(2)]
        p_ms.append(_time_ms(plain, 10))
        graph_us = _graph_us(call)
        vox = live.numel()
        bound = _bound(4 * 6 * vox, OPS_STEP2D * vox)  # live, canonical, u in and u' out
        if row is None:
            row = (min(k_ms), min(p_ms), bound)
        lines.append(f"{preset} {shape} (taps {len(kw['taps'])}): {min(k_ms) * 1e3:.2f} us a "
                     f"call after a spin (runs {[round(t * 1e3, 2) for t in k_ms]}), "
                     f"{graph_us:.2f} us a call in a CUDA graph of 16, plain "
                     f"{min(p_ms) * 1e3:.1f} us (runs {[round(t * 1e3, 1) for t in p_ms]}), "
                     f"bound {bound[0] * 1e3:.4f} us ({bound[1]})")
    print(f"[3b] 2D step vs plain at {STEP2D_SHAPES}, 5 term sets each: warp max|Δ| "
          f"{worst['warp']:.3e}, maxes {worst['maxes']:.3e} (atol {STEP2D_WARP_TOL}), sums "
          f"max rel {worst['sums']:.3e} (rtol {STEP2D_SUM_RTOL}); flag off writes nothing; "
          f"{calls} launches counted; {'; '.join(lines)}")
    return (max(worst["warp"], worst["maxes"]), *row)


# The loop tail's limit a call in a CUDA graph, as the solve loop replays it:
# one dependent node of one warp costs about 2 us on the H100, so twice that.
LOOP_TAIL_LIMIT_US = 4.0
TAIL_CAP = 24  # a short iteration cap, so that sequences reach it


def _tail_state(dim, n, seed):
    """The loop's buffers as ``_solve`` seeds them, the telemetry filled
    with 7 so that an unwritten entry shows."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device="cuda")
    return {"rate": torch.tensor(0.5, **f32), "prev_energy": torch.tensor(float("inf"), **f32),
            "telemetry": torch.full((5, n + 1), 7.0, **f32),
            "max_disp": torch.tensor(rng.uniform(0.0, 1.0, dim), **f32),
            "max_update": torch.tensor(float("inf"), **f32),
            "iteration": torch.zeros((), dtype=torch.int64, device="cuda"),
            "active": torch.tensor(True, device="cuda")}


def _tail_stats(rng, dim, step, threshold):
    """One iteration's stats: energies that mostly fall and now and then
    rise, an update that stays above the threshold but now and then falls
    below it, and a NaN or an infinity in one call of ~30."""
    energies = rng.uniform(0.2, 0.4, 3) * (1.0 + 0.05 * rng.standard_normal()) / (1 + step)
    stats = np.concatenate([energies, [rng.uniform(1.0, 9.0)],
                            [rng.uniform(0.9, 3.0) * threshold], rng.uniform(0.5, 3.0, dim)])
    odd = rng.uniform()
    if odd < 0.02:
        stats[rng.integers(len(stats))] = float("nan")
    elif odd < 0.035:
        stats[rng.integers(len(stats))] = float("inf")
    return torch.from_numpy(stats.astype(np.float32)).cuda()


def _tail_call(fn, stats, flag, s, kw):
    fn(stats, flag, s["rate"], s["prev_energy"], s["telemetry"], s["max_disp"],
       s["max_update"], s["iteration"], s["active"], **kw)


def _tail_differs(got, want, n):
    """The buffers where the kernel's differ from the plain version's (NaN
    equal to NaN); the telemetry's first ``n`` columns, since the plain
    version writes a frozen call's entries into the spare column ``n``."""
    bad = []
    for key in got:
        a, b = got[key], want[key]
        if key == "telemetry":
            a, b = a[:, :n], b[:, :n]
        same = a == b
        if a.is_floating_point():
            same |= torch.isnan(a) & torch.isnan(b)
        if not bool(same.all()):
            bad.append(key)
    return bad


def phase3c_loop_tail():
    """The loop tail (``loop_tail``, one launch an iteration of every solve
    loop, 2D and 3D) against its plain version on the card, on the same
    inputs, at config1's stats (7) and telemetry and config3's (8): the
    presets' caps and threshold and a cap of TAIL_CAP, the adaptive rate on
    and off, the flag aliased to ``active`` (fed back, as in a chunk) and a
    separate flag that is on; sequences of random stats with NaN and
    infinities, every buffer equal after every call (max|Δ| 0), the spare
    telemetry column never written; now and then a call with a separate
    false flag, which must write nothing. The launches counted equal the
    calls. Then the tail timed at both shapes in a CUDA graph of 16 calls,
    as the loop replays it, on and frozen, against LOOP_TAIL_LIMIT_US, and
    its plain version's ops after a spin. Returns (max|Δ|, launches, ms,
    plain ms, bound) at config1."""
    loop_tail.launch_count = 0
    calls, sequences, off_calls, lines, row = 0, 0, 0, [], None
    for preset, shape in ((C1, CONFIG1), (PRESET, FULL)):
        params, dim = PRESETS[preset].solver, len(shape)
        threshold = float(np.float32(params.convergence_threshold))
        for cap in (params.max_iterations, TAIL_CAP):
            for adaptive in (True, False):
                kw = dict(threshold=threshold, voxels=int(np.prod(shape)), adaptive=adaptive)
                for aliased in (True, False):
                    seed = 40 + 8 * dim + 4 * (cap == TAIL_CAP) + 2 * adaptive + aliased
                    rng = np.random.default_rng(seed)
                    got = _tail_state(dim, cap, seed)
                    want = {k: v.clone() for k, v in got.items()}
                    # A separate flag that stays on runs the count up to the
                    # cap and stops there: the plain version would index past
                    # the spare column.
                    for step in range(TAIL_CAP + 6 if aliased else min(TAIL_CAP + 6, cap)):
                        stats = _tail_stats(rng, dim, step, threshold)
                        flags = ((got["active"], want["active"]) if aliased else
                                 (torch.tensor(True, device="cuda"),) * 2)
                        _tail_call(loop_tail.loop_tail, stats, flags[0], got, kw)
                        _tail_call(loop_tail.loop_tail_reference, stats, flags[1], want, kw)
                        calls += 1
                        name = (f"loop_tail {preset} cap {cap} adaptive {adaptive} aliased "
                                f"{aliased} step {step}")
                        bad = _tail_differs(got, want, cap)
                        if bad or not bool((got["telemetry"][:, cap] == 7.0).all()):
                            raise AssertionError(f"{name}: differs from the plain version in "
                                                 f"{bad or 'the spare column'}")
                        if step % 7 == 3:
                            before = {k: v.clone() for k, v in got.items()}
                            _tail_call(loop_tail.loop_tail, stats,
                                       torch.tensor(False, device="cuda"), got, kw)
                            calls += 1
                            off_calls += 1
                            torch.cuda.synchronize()
                            if _tail_differs(got, before, cap + 1):
                                raise AssertionError(f"{name}: a call with the flag off wrote")
                    sequences += 1
    if loop_tail.launch_count != calls:
        raise AssertionError(f"loop_tail: {loop_tail.launch_count} launches counted for "
                             f"{calls} calls")
    for preset, shape in ((C1, CONFIG1), (PRESET, FULL)):
        params, dim = PRESETS[preset].solver, len(shape)
        kw = dict(threshold=float(np.float32(params.convergence_threshold)),
                  voxels=int(np.prod(shape)), adaptive=params.adaptive_learning_rate)
        s = _tail_state(dim, params.max_iterations, 1)
        stats = _tail_stats(np.random.default_rng(1), dim, 0, kw["threshold"])
        on, off = torch.tensor(True, device="cuda"), torch.tensor(False, device="cuda")
        # The kernel keeps a call past the cap in the spare column; the plain
        # version's calls start from iteration 0, fewer than the cap.
        graph_us = _graph_us(lambda: _tail_call(loop_tail.loop_tail, stats, on, s, kw))
        frozen_us = _graph_us(lambda: _tail_call(loop_tail.loop_tail, stats, off, s, kw))
        s["iteration"].zero_()
        plain_ms = _time_ms(lambda: _tail_call(loop_tail.loop_tail_reference, stats, on, s, kw),
                            params.max_iterations // 2 - 1)
        if graph_us > LOOP_TAIL_LIMIT_US or graph_us > plain_ms * 1e3:
            raise AssertionError(f"loop_tail at {shape}: {graph_us:.2f} us a call in a graph, "
                                 f"limit {LOOP_TAIL_LIMIT_US}, plain {plain_ms * 1e3:.2f} us")
        # Bytes: the stats and the scalars read, the column, the maxes and the
        # scalars written.
        bound = _bound(4 * (5 + dim) + 4 * (5 + 2 * dim) + 4 * 3 * 2 + 8 * 2 + 2, 10 + dim)
        if row is None:
            row = (graph_us * 1e-3, plain_ms, bound)
        lines.append(f"{preset} {shape}: {graph_us:.2f} us a call in a CUDA graph of 16 "
                     f"(frozen {frozen_us:.2f}; limit {LOOP_TAIL_LIMIT_US}), plain "
                     f"{plain_ms * 1e3:.1f} us after a spin")
    print(f"[3c] loop tail vs plain at config1's and config3's stats, caps "
          f"({PRESETS[C1].solver.max_iterations}, {PRESETS[PRESET].solver.max_iterations}, "
          f"{TAIL_CAP}), adaptive on and off, flag aliased and separate: {sequences} "
          f"sequences, every buffer equal after each of {calls - off_calls} calls (max|Δ| 0); "
          f"{off_calls} calls with the flag off wrote nothing; {calls} launches counted; "
          f"{'; '.join(lines)}")
    return (0.0, *row)


def phase4_solve_parity():
    cfg = PRESETS[PRESET]
    small = dataclasses.replace(cfg, grid_shape=(32, 32, 64), grid_offset=(-16, -16, 70))
    params = cfg.solver.replace(max_iterations=30, convergence_threshold=0.0)
    canonical, live = _pair_3d(small, _grid(small), torch.device("cpu"))
    ref = solve_single_level(canonical, live, params)
    got = solve_single_level(canonical.cuda(), live.cuda(), params)
    if got.iterations != ref.iterations:
        raise AssertionError(f"iterations {got.iterations} != {ref.iterations}")
    err = _close("solve warp", got.warp.cpu(), ref.warp, 3e-4, 3e-6)
    for name, a, b in zip(ref.telemetry._fields, got.telemetry, ref.telemetry):
        _close(f"telemetry {name}", a.cpu(), b, 2e-4, 1e-8)
    print(f"[4] kernel solve (cuda) vs plain solve (cpu) at (32, 32, 64), "
          f"{got.iterations} iterations: warp max|Δ| {err:.3e} "
          f"(rtol 3e-4 atol 3e-6; telemetry rtol 2e-4)")


def _max_diff(a, b):
    return float(torch.max(torch.abs(a - b))) if a.numel() else 0.0


def _check_capture(loop, k):
    """The calls of each kernel that ``loop``'s capture recorded (what a
    replay adds to its launch counter) must be the chunk's ``k``: B1's and
    B2's in 3D, the 2D step's in 2D, the loop tail's in both."""
    recorded = {m.__name__.rsplit(".", 1)[-1]: c for m, c in loop.graph_launches.items()}
    three = loop.dim == 3
    if recorded != {"resample": k if three else 0, "fused_gradient": k if three else 0,
                    "step2d": 0 if three else k, "loop_tail": k}:
        raise AssertionError(f"the capture of a {k}-iteration chunk recorded {recorded}")


def phase4b_device_loop():
    """The graph loop (CHECK_EVERY iterations a replay) against the eager
    loop that reads the flag every iteration, on config3's inputs at 128³,
    in one process: the same kernels on the same inputs, so they must agree
    exactly. Then the graph's memory at two chunk lengths. Returns the
    serial loop's config3 iteration count."""
    cfg = PRESETS[PRESET]
    canonical, live = _pair_3d(cfg, _grid(cfg), torch.device("cuda"))
    lines, serial_it = [], None
    for name, kw in LOOP_CASES:
        params = cfg.solver.replace(**kw)
        serial, graph = SolveLoop(FULL, params, "cuda", **SERIAL), SolveLoop(FULL, params, "cuda")
        want, got = serial.solve(canonical, live), graph.solve(canonical, live)
        torch.cuda.synchronize()
        if (got.iterations, got.converged) != (want.iterations, want.converged):
            raise AssertionError(f"{name}: graph loop {got.iterations}, {got.converged} != "
                                 f"serial {want.iterations}, {want.converged}")
        diffs = {"warp": _max_diff(got.warp, want.warp),
                 "telemetry": max(_max_diff(a, b) for a, b in zip(got.telemetry, want.telemetry)),
                 "max|u|": _max_diff(got.max_abs_displacement, want.max_abs_displacement),
                 "rate": abs(float(graph.rate) - float(serial.rate))}
        if any(diffs.values()):
            raise AssertionError(f"{name}: graph loop differs from the serial loop: {diffs}")
        if name == "halving" and not float(serial.rate) < params.learning_rate:
            raise AssertionError(f"halving: the rate stayed {float(serial.rate)}")
        if name == "config3":
            serial_it = want.iterations
        _check_capture(graph, CHECK_EVERY)
        lines.append(f"{name} {got.iterations} iterations ({graph.replays} replays, "
                     f"{-got.iterations % CHECK_EVERY} frozen), converged {got.converged}, "
                     f"rate {float(graph.rate):g}")
    # The graph's pool holds one iteration's scratch whatever the chunk:
    # reserved memory grown by a loop's first solve, at 2 and CHECK_EVERY.
    growth = {}
    for k in (2, CHECK_EVERY):
        loop = SolveLoop(FULL, cfg.solver.replace(max_iterations=k, convergence_threshold=0.0),
                         "cuda", check_every=k)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        loop.solve(canonical, live)
        torch.cuda.synchronize()
        growth[k] = (torch.cuda.memory_reserved() - before) / 2**20
        _check_capture(loop, k)
        del loop
    if growth[CHECK_EVERY] > growth[2] + 4.0:
        raise AssertionError(f"the graph's memory grows with the chunk: {growth} MiB")
    scratch = 4 * 4 * canonical.numel() / 2**20  # the warped field and g
    print(f"[4b] graph loop (check every {CHECK_EVERY}) vs the serial loop (flag read every "
          f"iteration) at {FULL}: {'; '.join(lines)}; iterations, converged, warp, telemetry, "
          f"max|u| and rate all exact (max|Δ| 0); reserved memory grown by the first solve "
          f"(capture included) at k = 2 and {CHECK_EVERY}: {growth[2]:.1f} and "
          f"{growth[CHECK_EVERY]:.1f} MiB (one iteration's warped field and g: {scratch:.1f} MiB)")
    return serial_it


def _chunk_launches(iterations):
    """Each kernel's launches of the solves that ran ``iterations`` active
    iterations on one SolveLoop: one frozen warm-up before the capture, then
    CHECK_EVERY a replay, a replay for every started chunk. The counters get
    a replay's launches from the calls the wrappers counted while capturing,
    so a chunk that recorded another number fails the check."""
    return 1 + CHECK_EVERY * sum(-(-it // CHECK_EVERY) for it in iterations)


def phase5_main_path(serial_it):
    release_kept_loops()  # the counts below take a new loop's warm-up and capture
    with tempfile.TemporaryDirectory() as out:
        _reset_launches()
        t0 = time.perf_counter()
        summary = run_experiment(PRESETS[PRESET], out, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
    it = summary["iterations"]
    want = {"resample": _chunk_launches([it]) + 1, "fused_gradient": _chunk_launches([it]),
            "loop_tail": _chunk_launches([it])}
    print(f"[5] {PRESET} at {FULL} on cuda: iterations {it} (serial loop {serial_it}; "
          f"{-(-it // CHECK_EVERY)} replays of {CHECK_EVERY}), converged "
          f"{summary['converged']}, residual {summary['residual_before']:.6f} -> "
          f"{summary['residual_after']:.6f} (reduction "
          f"{summary['residual_reduction']:.4f}), max|u| "
          f"{summary['max_abs_displacement']}, wall {wall:.2f} s, launches {launches}")
    numbers = [summary["residual_before"], summary["residual_after"],
               summary["final_data_energy"], *summary["max_abs_displacement"]]
    if not all(np.isfinite(numbers)):
        raise AssertionError(f"non-finite results: {numbers}")
    if not summary["converged"]:
        raise AssertionError("config3 did not converge")
    if it != serial_it:
        raise AssertionError(f"config3 took {it} iterations, the serial loop {serial_it}")
    if not summary["residual_reduction"] >= 2.0:
        raise AssertionError("config3 residual reduction < 2")
    # A replay launches the calls its capture recorded, CHECK_EVERY of each
    # kernel (B1, B2 and the tail), frozen ones too; a warm-up before the
    # capture, and the final resample, add one each.
    if launches != want or summary["kernel_launches"] != {**want, "step2d": 0}:
        raise AssertionError(f"launch counts {launches} (summary.json: "
                             f"{summary['kernel_launches']}) for {it} iterations, want {want}")
    return launches


def phase6_timing():
    # bench.py's headline inputs: in-band random fields from seed 0.
    rng = np.random.default_rng(0)
    base = rng.standard_normal(FULL).astype(np.float32)
    canonical = torch.from_numpy(np.tanh(base * 0.3)).cuda()
    live = torch.from_numpy(np.tanh(np.roll(base, 1, axis=0) * 0.3)).cuda()
    params = PRESETS[PRESET].solver.replace(
        max_iterations=BENCH_ITERS, convergence_threshold=0.0
    )
    # The rate cell through the graph loop and the serial loop, in turns;
    # each loop's first solve (the build, the capture) is not timed.
    loops = {"serial": SolveLoop(FULL, params, "cuda", **SERIAL),
             "graph": SolveLoop(FULL, params, "cuda")}
    for loop in loops.values():
        loop.solve(canonical, live)
    runs = {"serial": [], "graph": []}
    for mode in ("serial", "graph", "graph", "serial"):
        runs[mode].append(_solve_ms(loops[mode], canonical, live))
    solve_ms, serial_ms = min(runs["graph"]), min(runs["serial"])
    rate = float(np.prod(FULL)) * BENCH_ITERS / (solve_ms / 1e3)
    frozen = _frozen_us(canonical, live, params)

    warp = torch.from_numpy(
        rng.uniform(-2.0, 2.0, (3,) + FULL).astype(np.float32)
    ).cuda()
    lr = torch.tensor(0.5, device="cuda")
    p = params
    kw = dict(w_data=p.data_term_weight, w_smooth=p.smoothing_term_weight,
              w_ls=p.level_set_term_weight, killing=True,
              gamma=p.rigidity_enforcement_factor, band_union=p.band_union_only,
              taps=sobolev_taps(p.sobolev_kernel_size, p.sobolev_strength))
    warped = warp_field_cm(live, warp)
    # B1's yardstick: grid_sample on the same inputs (its grid built outside
    # the timed call), held to B1 within 1e-4 (normalised coordinates).
    gs_call, gs_value = _field_grid_sample(live, warp.movedim(0, -1))
    gs_err = _close("grid_sample vs B1", gs_value(gs_call()), warped, 0.0, 1e-4)
    # Plain, library, kernel, kernel, library, plain: compare within one
    # call, in turns.
    r_plain = [_time_ms(lambda: warp_field_cm_reference(live, warp), 10)]
    r_lib = [_time_ms(gs_call, 100)]
    r_kern = [_time_ms(lambda: warp_field_cm(live, warp), 100) for _ in range(2)]
    # What the host takes to enqueue one call, against the kernel's time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        warp_field_cm(live, warp)
    enqueue_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    r_lib.append(_time_ms(gs_call, 100))
    r_plain.append(_time_ms(lambda: warp_field_cm_reference(live, warp), 10))
    f_plain = [_time_ms(lambda: fused_gradient_update_reference(
        warped, canonical, warp, lr, **kw), 5)]
    f_kern = [_time_ms(lambda: fused_gradient_update(
        warped, canonical, warp, lr, **kw), 50) for _ in range(2)]
    f_plain.append(_time_ms(lambda: fused_gradient_update_reference(
        warped, canonical, warp, lr, **kw), 5))
    times = {
        "resample": (min(r_kern), min(r_plain)),
        "fused_gradient": (min(f_kern), min(f_plain)),
    }
    big_ms = _fused_ms_at(BIG, kw)
    per_iter = solve_ms / BENCH_ITERS
    short = params.replace(max_iterations=PROFILE_ITERS)
    profiles = [_profile_solve(SolveLoop(FULL, short, "cuda", **kw), canonical, live,
                               ms / BENCH_ITERS * 1e3, label)
                for label, kw, ms in (("graph", {}, solve_ms),
                                      ("serial", SERIAL, serial_ms))]
    vox = live.numel()
    bounds = {"resample": _bound(4 * 5 * vox, OPS_RESAMPLE * vox),
              "fused_gradient": _bound(4 * 8 * vox, OPS_FUSED * vox)}
    print(f"[6] solve at {FULL}, {BENCH_ITERS} iterations, threshold 0, graph loop: "
          f"{solve_ms:.1f} ms, {per_iter * 1e3:.1f} us/iter, {rate:.4e} voxel*iter/s; serial "
          f"loop {serial_ms:.1f} ms, {serial_ms / BENCH_ITERS * 1e3:.1f} us/iter (runs serial, "
          f"graph, graph, serial: {[round(v, 2) for v in (runs['serial'][0], *runs['graph'], runs['serial'][1])]} ms); "
          f"{frozen}; "
          f"resample {times['resample'][0] * 1e3:.1f} us (plain "
          f"{times['resample'][1] * 1e3:.1f} us, grid_sample {min(r_lib) * 1e3:.1f} us, "
          f"max|Δ| {gs_err:.2e} vs B1, bound {bounds['resample'][0] * 1e3:.1f} us, "
          f"B1/grid_sample {times['resample'][0] / min(r_lib):.3f}, host enqueue "
          f"{enqueue_us:.1f} us a call); "
          f"fused gradient {times['fused_gradient'][0] * 1e3:.1f} us (plain "
          f"{times['fused_gradient'][1] * 1e3:.1f} us, bound "
          f"{bounds['fused_gradient'][0] * 1e3:.1f} us); runs kernel "
          f"{[round(t * 1e3, 1) for t in r_kern + f_kern]} us, plain "
          f"{[round(t * 1e3, 1) for t in r_plain + f_plain]} us, grid_sample "
          f"{[round(t * 1e3, 1) for t in r_lib]} us")
    print(f"[6] fused gradient at {BIG}: {big_ms * 1e3:.1f} us per call (best of two "
          f"runs of 20; bound {_bound(4 * 8 * np.prod(BIG), OPS_FUSED * np.prod(BIG))[0] * 1e3:.1f}"
          f" us)")
    for profile in profiles:
        print(f"[6] {profile}")
    return {name: (*times[name], bounds[name]) for name in times}, min(r_lib)


def _fused_ms_at(shape, kw):
    """Best of two runs of 20 calls of B2 at ``shape``, ms per call."""
    canonical, warped, warp = _fields(shape, 5, 0.8)
    lr = torch.tensor(0.5, device="cuda")
    runs = [_time_ms(lambda: fused_gradient_update(warped, canonical, warp, lr, **kw), 20)
            for _ in range(2)]
    return min(runs)


def _short_kernel(name):
    """A device event's name without its arguments, namespaces or (for
    PyTorch's own kernels) template arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    return name if len(name) < 40 else name.split("<")[0]


def _solve_ms(loop, canonical, live):
    """One solve of ``loop`` by CUDA events (the solve ends on a host read
    of the done flag, so the end event follows its last chunk)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    loop.solve(canonical, live)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _frozen_us(canonical, live, params):
    """What a frozen iteration of the graph loop costs: graph solves of
    n = k, k + 1 and 2k iterations (k = CHECK_EVERY; one replay, two with
    k - 1 frozen, two with none), best of 5 each. An active iteration costs
    A = (t_2k - t_k) / k, a frozen one A - (t_2k - t_k+1) / (k - 1)."""
    k = CHECK_EVERY
    best = {}
    for n in (k, k + 1, 2 * k):
        loop = SolveLoop(FULL, params.replace(max_iterations=n), "cuda")
        loop.solve(canonical, live)
        best[n] = min(_solve_ms(loop, canonical, live) for _ in range(5)) * 1e3
    active = (best[2 * k] - best[k]) / k
    frozen = active - (best[2 * k] - best[k + 1]) / (k - 1)
    return (f"graph solves of {k}, {k + 1}, {2 * k} iterations {best[k]:.1f}, "
            f"{best[k + 1]:.1f}, {best[2 * k]:.1f} us: an active iteration {active:.1f} us, "
            f"a frozen one {frozen:.1f} us")


def _device_busy_us(prof):
    """(µs the device was busy: the union of a ``torch.profiler`` run's
    device events, {kernel: device µs}); (0, {}) without device events."""
    from torch.autograd import DeviceType

    per_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = _short_kernel(e.name)
        per_name[key] = per_name.get(key, 0.0) + e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy, per_name


def _profile_solve(loop, canonical, live, wall_us, label, where=f"config3 solve at {FULL}"):
    """``torch.profiler`` over one solve of ``loop`` (after an unprofiled
    one): device µs per iteration by kernel name and device-busy µs per
    iteration (the union of the device events), against ``wall_us``, the
    µs per iteration of the rate cell's solve on the same kind of loop
    timed without the profiler (which slows the host); their difference is
    the host gap."""
    from torch.profiler import ProfilerActivity, profile

    iters = loop.params.max_iterations
    loop.solve(canonical, live)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.solve(canonical, live)
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) * 1e6
    busy, per_name = _device_busy_us(prof)
    if not per_name:
        return f"profiler over a {iters}-iteration {label} solve: no device events (not measured)"
    table = ", ".join(f"{k} {v / iters:.1f}" for k, v in
                      sorted(per_name.items(), key=lambda kv: -kv[1])[:10])
    return (f"profiler over a {iters}-iteration {label} {where}: device busy "
            f"{busy / iters:.1f} us/iter against {wall_us:.1f} us/iter of wall without the "
            f"profiler: host gap {wall_us - busy / iters:.1f} us/iter, idle share "
            f"{1 - busy / iters / wall_us:.1%} (wall with the profiler "
            f"{profiled_us / iters:.1f} us/iter); device us/iter by kernel: {table}")


def _ptxas(library):
    """``name<template ints> <registers>r/<spill bytes>B/<stack frame
    bytes>B/<static shared bytes>S`` of every kernel in a library's ``nvcc
    -Xptxas -v`` log (built in phase 1)."""
    log = (_lib.BUILD_DIR / f"lib{library}.log").read_text()
    return [f"{_sweep.kernel_name(mangled)} {'?' if regs is None else regs}r/{spill}B/{stack}B/"
            f"{smem}S" for mangled, (regs, spill, stack, smem) in _sweep.ptxas(log).items()]


# B9's full body under both loops, at the tile and voxels a thread of the
# script's shape (loop_cost.b9_geometry).
B9_FULL = {loop: f"loop_kernel<4,{i},{loop_cost.B9_TILE_ROWS},{loop_cost.B9_VOXELS}>"
           for i, loop in enumerate(loop_cost.LOOP_KINDS)}
# Phase 7's SASS counts: (library, kernel, what it runs, shared loads of its
# pair loop: one pair's for each voxel it sums at once, since each runtime
# loop must run one pair a step; None for the static unroll).
SASS_KERNELS = (
    ("stack_bodies", B9_FULL["fori"], "B9 full fori", 2 * loop_cost.B9_VOXELS),
    ("stack_bodies", B9_FULL["static"], "B9 full static", None),
    ("stack_bodies", "table_kernel<9,4>", "B7 v8", 4),
    ("stack_bodies", "table_kernel<10,1>", "B7 v8c", 3),
    ("stack_bodies", "table_kernel<8,4>", "B8 level 4", 2),
    ("resample_variants", "tile_kernel<0,0>", "B3 v6", 2),
    ("resample_variants", "ring_kernel<0,0>", "B4 vf_fori", 2),
    ("resample_variants", "ring_kernel<2,1>", "B5 v7_chunk", 24),
)
# Kernels whose pair loop runs other than once a pair for one voxel:
# (trips, voxels at once). B5's chunk sums a thread's two voxels in one loop
# of 6 cy steps; B9 sums a thread's voxels together, fori in one loop of 36
# pairs, static in its unrolled step.
SASS_LOOPS = {"ring_kernel<2,1>": (6, 2),
              **{name: (loop_cost.NBODY, loop_cost.B9_VOXELS) for name in B9_FULL.values()}}


def phase7_ptxas():
    """Registers, spills and stack frames of every experiment kernel
    instantiation (built in phase 1), from each library's ``nvcc -Xptxas
    -v`` log, and the SASS a voxel of the pair-loop kernels."""
    parts = [f"{name}: {', '.join(_ptxas(name))}" for name in LIBRARIES[len(MAIN_LIBRARIES):]]
    # B12's banded kernels, B5's ring kernels (ring_kernel<loop, 1>), B10's
    # ring, B9's loop_kernel and the solve loop's tail must not touch local
    # memory.
    for library, redesigned in (("conv_yz", "banded"),
                                ("resample_variants", r"^ring_kernel<\d+,1>$"),
                                ("dma_probe", r"^dma_probe_kernel$"),
                                ("stack_bodies", r"^loop_kernel<"),
                                ("loop_tail", r"^loop_tail_kernel$")):
        log = (_lib.BUILD_DIR / f"lib{library}.log").read_text()
        for mangled, (_, spill, stack, _) in _sweep.ptxas(log).items():
            name = _sweep.kernel_name(mangled)
            if re.search(redesigned, name) and (spill or stack):
                raise AssertionError(f"{name}: {spill} B spilled, {stack} B stack frame")
    print(f"[7] ptxas, registers r / spill bytes B / stack frame bytes B / static shared S "
          f"(window_kernel<loop, body, tents_once>, tile_kernel<loop, body> and "
          f"ring_kernel<loop, tents_once> as codes of "
          f"resample_variants.LOOPS and BODIES, loop_kernel<body, loop, TY, voxels> and "
          f"table_kernel<body, TY> of loop_cost.BODIES and LOOPS): {'; '.join(parts)}")
    found = []
    for library in dict.fromkeys(row[0] for row in SASS_KERNELS):
        kernels = {name: (what, lds) for lib, name, what, lds in SASS_KERNELS if lib == library}
        counts = _sweep.sass_per_voxel(_lib.BUILD_DIR / f"lib{library}.so", kernels,
                                       SASS_LOOPS)
        if not counts:
            break  # no cuobjdump
        for name, (what, lds) in kernels.items():
            c = counts.get(name)
            if c is None or "error" in c:
                raise AssertionError(f"{name}: {c['error'] if c else 'not in the SASS'}")
            if c["pair_loop_lds"] != lds:
                raise AssertionError(f"{name} ({what}): pair loop with {c['pair_loop_lds']} "
                                     f"shared loads, want {lds} (one step of its loop)")
            loop = (f", pair loop {c['pair_loop']} ({c['pair_loop_lds']} LDS)"
                    if c["pair_loop"] else ", no loop")
            found.append(f"{name} ({what}): {c['instructions']:g} instructions{loop}, "
                         f"LDL {c['ldl']:g}, STL {c['stl']:g}")
    print(f"[7] SASS a voxel (the step's code once, its pair loop {_sweep.PAIRS} times; "
          f"{SASS_LOOPS} as (trips, voxels)): "
          f"{'; '.join(found) or 'cuobjdump not found'}")


def _b12_matrices(n, rng):
    """C matrices (n, n) whose zero blocks are not the 7-tap band's: dense
    random, scaled by 1/sqrt(n) so that the outputs stay O(1) (every k
    step), the 15-tap band, and one nonzero far off the diagonal (all but
    one tile empty)."""
    off = np.zeros((n, n), np.float32)
    off[n // 8, n - 3] = 1.5
    return {"dense": (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32),
            "band15": mxu_conv.band(n, sobolev_taps(15, 0.1)), "offdiag": off}


def _bf16_rule(name, got, want):
    """The bf16 route against its plain version; returns (max|Δ|, the share
    of values over 1e-4). The two sum each intermediate in another order, so
    where it lies within a float32 rounding of a bf16 rounding boundary they
    round it to neighbouring bf16 values (a step of <= 2^-7 relative). Hence
    1e-4 on all but 0.1% of the values, and 1e-2 (outputs are O(1)) on
    every value."""
    err = torch.abs(got - want)
    off = float(torch.mean((err > 1e-4).float()))
    if off > 1e-3 or float(torch.max(err)) > 1e-2:
        raise AssertionError(f"{name}: max|Δ| {float(torch.max(err)):.3e}, {off:.2e} over 1e-4")
    return float(torch.max(err)), off


def _bf16_step_bound(a, cy, cz):
    """Per value, what one bf16 step (<= 2^-7 relative) in every
    intermediate of one pass can move the output: 2^-7 |tmp| |C_z|, the
    operands rounded as the bf16 route rounds them."""
    def r(v):
        return v.bfloat16().float()

    tmp = torch.einsum("yY,xyz->xYz", r(cy), r(a))
    return 2.0 ** -7 * torch.einsum("xYz,zZ->xYZ", tmp.abs(), r(cz).abs())


B12_SHAPES = ((16, 128, 128), (5, 48, 80))
# A plane whose dense band fragments do not fit the stage in either route,
# so that both load them from global memory at each step.
B12_UNSTAGED = (2, 16, 1024)


def phase8_mxu_conv():
    mxu_conv.launch_counts.update(dict.fromkeys(mxu_conv.launch_counts, 0))
    runs = [mxu_conv.run(shape=shape, reps=1024, device="cuda")
            for shape in ((16, 128, 128), FULL)]
    launches = dict(mxu_conv.launch_counts)
    if min(launches.values()) == 0:
        raise AssertionError(f"mxu_conv.run left a kernel unlaunched: {launches}")
    worst = {"stencil": 0.0, "banded_f32": 0.0, "banded_bf16": 0.0}
    off_bf16 = 0.0
    for shape in B12_SHAPES:
        a, taps, cy, cz = mxu_conv.inputs(shape, "cuda")
        for reps in (1, 3):
            plain = mxu_conv.conv_yz_stencil_reference(a, taps, reps)
            for key, got in (("stencil", mxu_conv.conv_yz_stencil(a, taps, reps)),
                             ("banded_f32", mxu_conv.conv_yz_banded_f32(a, cy, cz, reps))):
                worst[key] = max(worst[key], _close(
                    f"conv_yz {key} {shape} reps {reps}", got, plain, 0.0, 1e-5))
            err, off = _bf16_rule(f"conv_yz banded_bf16 {shape} reps {reps}",
                                  mxu_conv.conv_yz_banded_bf16(a, cy, cz, reps),
                                  mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, reps))
            worst["banded_bf16"] = max(worst["banded_bf16"], err)
            off_bf16 = max(off_bf16, off)
    # The steps walked follow the matrices passed in. A call of 3 passes
    # equals three calls of one, exactly. 3xTF32 keeps float32 accuracy, so
    # it is held to 1e-5 of the output's scale, max|plain|, where each
    # output sums at most 128 products (a dense C's sums reach a few units);
    # the dense C of B12_UNSTAGED sums 1024 (2.0e-5 of the scale at 3
    # passes), so there the exact repeat is its check. bf16 follows the rule
    # of _bf16_rule, but an output of a dense C sums 80-1024 intermediates,
    # any of which may round to the neighbouring bf16 value: one pass is
    # held per value to _bf16_step_bound, more by the exact repeat.
    rng = np.random.default_rng(8)
    rel_f32 = 0.0
    routes = (("banded_f32", mxu_conv.conv_yz_banded_f32),
              ("banded_bf16", mxu_conv.conv_yz_banded_bf16))
    for shape in (*B12_SHAPES, B12_UNSTAGED):
        a = mxu_conv.inputs(shape, "cuda")[0]
        mats = [_b12_matrices(size, rng) for size in shape[1:]]
        for kind in mats[0]:
            cy, cz = (torch.from_numpy(m[kind]).cuda() for m in mats)
            name = f"conv_yz {kind} {shape}"
            for key, call in routes:
                once = a
                for _ in range(3):
                    once = call(once, cy, cz, 1)
                _close(f"{name} {key} 3 passes", call(a, cy, cz, 3), once, 0.0, 0.0)
            for reps in (1, 3):
                if (kind, shape) != ("dense", B12_UNSTAGED):
                    plain = mxu_conv.conv_yz_banded_reference(a, cy, cz, reps)
                    scale = float(torch.max(torch.abs(plain)))
                    err = _close(f"{name} banded_f32 reps {reps}",
                                 mxu_conv.conv_yz_banded_f32(a, cy, cz, reps), plain, 0.0,
                                 1e-5 * scale)
                    rel_f32 = max(rel_f32, err / scale if scale else 0.0)
                    worst["banded_f32"] = max(worst["banded_f32"], err)
                got = mxu_conv.conv_yz_banded_bf16(a, cy, cz, reps)
                want = mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, reps)
                if kind != "dense":
                    err, off = _bf16_rule(f"{name} banded_bf16 reps {reps}", got, want)
                    off_bf16 = max(off_bf16, off)
                elif reps == 1:
                    err = _close(f"{name} banded_bf16 reps 1", got, want, 0.0,
                                 _bf16_step_bound(a, cy, cz) + 1e-5 * float(want.abs().max()))
                else:
                    continue
                worst["banded_bf16"] = max(worst["banded_bf16"], err)
    a, taps, cy, cz = mxu_conv.inputs(FULL, "cuda")
    ones = torch.ones_like(cy)
    mma = {route: (mxu_conv.mma_count(cy, cz, bf16), mxu_conv.mma_count(ones, ones, bf16))
           for route, bf16 in (("tc_f32", False), ("tc_bf16", True))}
    plain_ms = {
        "stencil": best_ms(lambda: mxu_conv.conv_yz_stencil_reference(a, taps, 1), a.device, 3),
        "banded_f32": best_ms(lambda: mxu_conv.conv_yz_banded_reference(a, cy, cz, 1),
                              a.device, 3),
        "banded_bf16": best_ms(lambda: mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, 1),
                               a.device, 3),
    }
    full = runs[1]
    ms = {"stencil": full["stencil_us_per_convpass"] / 1e3,
          "banded_f32": full["tc_f32_us_per_convpass"] / 1e3,
          "banded_bf16": full["tc_bf16_us_per_convpass"] / 1e3}
    # Yardsticks, one call per conv pass: the stencil as one conv2d with the
    # taps' outer product (cuDNN, TF32 off as the package sets it), the
    # banded routes as one einsum over C_y, A, C_z (bf16 operands for bf16).
    k2 = torch.tensor(taps, device="cuda")
    k2 = torch.outer(k2, k2)[None, None]
    bf = [v.bfloat16() for v in (cy, a, cz)]
    library = {
        "stencil": (lambda: F.conv2d(a[:, None], k2, padding=len(taps) // 2),
                    lambda out: out[:, 0], 1e-5),
        "banded_f32": (lambda: torch.einsum("yY,xyz,zZ->xYZ", cy, a, cz),
                       lambda out: out, 1e-5),
        "banded_bf16": (lambda: torch.einsum("yY,xyz,zZ->xYZ", *bf),
                        lambda out: out.float(), 5e-2),  # bf16 output and intermediate
    }
    plain_one = {"stencil": mxu_conv.conv_yz_stencil_reference(a, taps, 1),
                 "banded_f32": mxu_conv.conv_yz_banded_reference(a, cy, cz, 1),
                 "banded_bf16": mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, 1)}
    library_ms, library_err = {}, {}
    for key, (call, value, tol) in library.items():
        library_err[key] = _close(f"{key} library", value(call()), plain_one[key], 0.0, tol)
        library_ms[key] = best_ms(call, a.device, 10)
    # One bound for the three routes: the block is resident (no HBM bytes
    # per pass), and the function is the 7-tap pair on f32 values; the
    # band products' extra work is the routes' design, not the function's.
    assert len(taps) == 7
    bound = _bound(0, OPS_CONV_YZ * a.numel())
    bounds = dict.fromkeys(worst, bound)
    print(f"[8] conv_yz vs plain at {B12_SHAPES}, reps 1 and 3, and the banded routes on "
          f"a dense C, the 15-tap band and one nonzero off the diagonal there and at "
          f"{B12_UNSTAGED}, 3 passes exactly 3 one-pass calls: max|Δ| {worst} (stencil, "
          f"tc_f32 1e-5 vs plain stencil; tc_f32 vs its plain 1e-5 of max|plain|, worst "
          f"{rel_f32:.2e}; tc_bf16 vs its bf16 plain: 1e-4 on all but {off_bf16:.2e} of "
          f"values, 1e-2 on all; a dense C one bf16 step an intermediate); mma.sync a slice and "
          f"pass at {FULL} (7-tap extents, dense): {mma}; "
          f"per conv pass at {FULL}, block resident: kernel ms {ms}, plain ms {plain_ms}, "
          f"library ms {library_ms} (max|Δ| vs plain {library_err}), bound ms "
          f"{bounds}; launches {launches}")
    return {key: _numbers(launches[key], worst[key], ms[key], plain_ms[key], bounds[key],
                          library_ms[key]) for key in worst}


def phase9_fused_io():
    fused_io_probe.launch_count = 0
    rows = fused_io_probe.main(device="cuda")
    launches = fused_io_probe.launch_count
    if launches == 0:
        raise AssertionError("fused_io_probe.main launched no kernel")
    we, ce, ue = fused_io_probe.pad(*fused_io_probe.inputs(FULL, "cuda"))
    worst = 0.0
    for body, rtol, atol in (("copy", 0.0, 0.0), ("arith", 0.0, 1e-6), ("rolls", 1e-5, 0.0)):
        want = fused_io_probe.fused_io_probe_reference(we, ce, ue, body)
        for xb in fused_io_probe.XBS:
            got = fused_io_probe.fused_io_probe(we, ce, ue, body, xb)
            worst = max(worst, _close(f"fused_io_probe {body} xb {xb}", got, want, rtol, atol))
    plain_ms = {body: best_ms(lambda: fused_io_probe.fused_io_probe_reference(we, ce, ue, body),
                              we.device, 3) for body in ("copy", "rolls")}
    ms = {body: next(r["ms"] for r in rows if r["body"] == body and r["xb"] == 16)
          for body in ("copy", "rolls")}
    # The copy body's yardstick: one Tensor.copy_ of the warp's interior.
    nx = we.shape[0] - 2 * fused_io_probe.H
    dst = torch.empty((3, nx, *we.shape[1:]), device=we.device)
    lib_ms = best_ms(lambda: dst.copy_(ue[:, fused_io_probe.H:fused_io_probe.H + nx]),
                     we.device, 10)
    _close("copy_ vs copy body", dst, fused_io_probe.fused_io_probe(we, ce, ue, "copy", 16),
           0.0, 0.0)
    vox = dst[0].numel()
    bounds = {"copy": _bound(4 * 6 * vox, 0),
              "rolls": _bound(fused_io_probe.plan_bytes(FULL), 13 * vox)}
    print(f"[9] fused_io_probe vs plain at {FULL}, 3 bodies x xb {fused_io_probe.XBS}: "
          f"max|Δ| {worst:.3e} (copy exact, arith 1e-6, rolls rtol 1e-5); xb 16: rolls "
          f"{ms['rolls'] * 1e3:.1f} us (plain {plain_ms['rolls'] * 1e3:.1f} us, bound "
          f"{bounds['rolls'][0] * 1e3:.1f} us), copy {ms['copy'] * 1e3:.1f} us (plain "
          f"{plain_ms['copy'] * 1e3:.1f} us, copy_ {lib_ms * 1e3:.1f} us, bound "
          f"{bounds['copy'][0] * 1e3:.1f} us); launches {launches}")
    return {body: _numbers(launches, worst, ms[body], plain_ms[body], bounds[body],
                           lib_ms if body == "copy" else None) for body in ms}


# B10 is held exactly at the probe's shape, 128^3, 256^3 and two ragged
# shapes: Y at the window's 32 rows and Z under a column; Z not a multiple of
# the column and a partial last x chunk.
DMA_EXACT = (dma_probe.SHAPE, FULL, BIG, (24, 32, 8), (40, 48, 72))


def phase10_dma():
    dma_probe.launch_count = 0
    dma_probe.main(device="cuda")
    launches = dma_probe.launch_count
    if launches == 0:
        raise AssertionError("dma_probe.main launched no kernel")
    for shape in DMA_EXACT:
        a, u = dma_probe.inputs(shape, "cuda")
        err = float(torch.max(torch.abs(dma_probe.run(a, u) - dma_probe.dma_probe_reference(a, u))))
        if err != 0.0:
            raise AssertionError(f"dma_probe {shape}: max|Δ| {err} != 0")
    coef = torch.tensor([1.0, -1.0], device="cuda").view(1, 1, 2)
    rows, parts = {}, []
    for shape in (FULL, BIG):  # 128^3 sits in the 50 MB L2 across calls; 256^3 does not
        a, u = dma_probe.inputs(shape, "cuda")
        calls = {
            "kernel": lambda: dma_probe.run(a, u),
            "plain": lambda: dma_probe.dma_probe_reference(a, u),
            # Yardstick: one baddbmm, 2a + [1, -1] @ (u0; u1), on views of the inputs.
            "baddbmm": lambda: torch.baddbmm(a.view(1, 1, -1), coef, u.view(1, 2, -1),
                                             beta=2.0),
        }
        lib_err = _close("baddbmm vs dma_probe", calls["baddbmm"]().view(a.shape),
                         dma_probe.dma_probe_reference(a, u), 0.0, 1e-5)
        ms = {}
        for key in ("kernel", "plain", "baddbmm", "baddbmm", "plain", "kernel"):  # in turns
            ms[key] = min(ms.get(key, float("inf")), best_ms(calls[key], a.device, 20))
        plan = dma_probe.plan(shape, dma_probe.sms_of(a.device))
        bound = _bound(4 * 4 * a.numel(), 3 * a.numel())
        rows[shape] = _numbers(launches, 0.0, ms["kernel"], ms["plain"], bound, ms["baddbmm"])
        parts.append(
            f"{shape}: {ms['kernel'] * 1e3:.2f} us (plain {ms['plain'] * 1e3:.2f}, baddbmm "
            f"{ms['baddbmm'] * 1e3:.2f} with max|Δ| {lib_err:.1e}, bound "
            f"{bound[0] * 1e3:.2f}; kernel/baddbmm {ms['kernel'] / ms['baddbmm']:.3f}), plan "
            f"{json.dumps(dma_probe.describe(plan))}, moved "
            f"{plan.moved_bytes / ms['kernel'] / 1e9:.2f} TB/s, useful "
            f"{4 * 4 * a.numel() / ms['kernel'] / 1e9:.2f} TB/s")
    print(f"[10] dma_probe exact (max|Δ| 0) at {', '.join(map(str, DMA_EXACT))}; "
          f"{'; '.join(parts)}; launches {launches}")
    return rows[FULL]


def phase11_b2_entry_points():
    fused_gradient.launch_count = 0
    ablation = fused_ablation.main(device="cuda")
    bench = fused_gradient_bench.main(device="cuda")
    launches = fused_gradient.launch_count
    if launches == 0:
        raise AssertionError("the B2 entry points launched no fused gradient kernel")
    numbers = [*ablation["ms_per_kernel_call"].values(), *bench["ms"].values(),
               bench["plain_step_ms"]]
    if not all(np.isfinite(numbers)) or min(numbers) <= 0:
        raise AssertionError(f"B2 entry points: bad times {numbers}")
    print(f"[11] fused_ablation and fused_gradient_bench at {FULL}: full "
          f"{bench['ms']['full(+sobolev)'] * 1e3:.1f} us per call vs plain step "
          f"{bench['plain_step_ms'] * 1e3:.1f} us ({bench['full_speedup_vs_plain']:.2f}x); "
          f"launches {launches}")


def phase12_resample_variants():
    t0 = time.perf_counter()
    rv = resample_variants
    names = (*rv.KERNELS, *B45_VARIANTS)
    rv.launch_counts.update(dict.fromkeys(rv.launch_counts, 0))
    rows = rv.main(device="cuda", names=names)
    launches = dict(rv.launch_counts)
    if min(launches.values()) == 0:
        raise AssertionError(f"resample_variants.main left a kernel unlaunched: {launches}")
    # Every variant equals its plain version (max|Δ| 0) at 128^3 and a ragged
    # X; B3, B4 and B5 also at a Y that is not a multiple of their tiles' 8
    # rows, which takes their runtime geometry (window_kernel) instead of the
    # compile-time tiles or ring.
    err = dict.fromkeys((*names, *B4_WINDOW, *B5_WINDOW), 0.0)
    for shape, group in ((FULL, names), (RAGGED_X, names),
                         (RAGGED_B3, (*rv.KERNELS, *B4_WINDOW, *B5_WINDOW))):
        field, warp = rv.inputs(shape, "cuda")
        for name in group:
            got = rv.variant_call(name)(field, warp)
            want = rv.resample_variant_reference(field, warp, name)
            err[name] = max(err[name], _close(f"{name} {shape}", got, want, 0.0, 0.0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {shape: (rv.b3_geometry(shape)["kernel"],
                       rv.b4_geometry(shape, min(64, shape[1]), sms=sms)["kernel"],
                       rv.b5_geometry(shape, min(64, shape[1]), sms=sms)["kernel"])
               for shape in (FULL, RAGGED_X, RAGGED_B3)}
    if kernels[FULL][2] != "ring":
        raise AssertionError(f"run_v7 at {FULL} takes {kernels[FULL][2]}, not the ring")
    field, warp = rv.inputs(FULL, "cuda")
    warp_cm = rv.clamp_warp(warp).movedim(-1, 0).contiguous()
    b1 = warp_field_cm(field, warp_cm)
    vs_b1 = max(_close(f"{name} vs B1", rv.variant_call(name)(field, warp), b1, 0.0, 1e-5)
                for name in names if name not in rv.TIMING_ONLY)
    plain_ms = {name: best_ms(lambda: rv.resample_variant_reference(field, warp, name),
                              field.device, 3) for name in names}
    b1_ms = best_ms(lambda: warp_field_cm(field, warp_cm), field.device, 20)
    # The value-preserving variants' yardstick: grid_sample on the clamped warp.
    gs_call, gs_value = _field_grid_sample(field, rv.clamp_warp(warp))
    gs_err = _close("grid_sample vs B1 (clamped)", gs_value(gs_call()), b1, 0.0, 1e-4)
    lib_ms = best_ms(gs_call, field.device, 20)
    ms = {r["variant"]: r["us_per_call"] / 1e3 for r in rows}
    table = ", ".join(f"{name} {ms[name] * 1e3:.1f} ({plain_ms[name] * 1e3:.0f})"
                      for name in names)
    vox = field.numel()
    ctas = {**{f"vf_{i}": rv.b4_geometry(FULL, 64, i, sms)["ctas"] for i in rv.VMEMFULL_INNERS},
            **{f"v7_{s}": rv.b5_geometry(FULL, 64, s, sms)["ctas"] for s in rv.V7_STRUCTURES}}
    print(f"[12] resample variants vs plain at {FULL} and {RAGGED_X}, B3, {B4_WINDOW} and "
          f"{B5_WINDOW} also at {RAGGED_B3} (B3, B4, B5 kernels {kernels}; the ring at {FULL}, "
          f"CTAs on {sms} SMs: {ctas}): "
          f"max|Δ| {max(err.values())} (exact), value-preserving vs B1 {vs_b1:.3e} (tol 1e-5); "
          f"us per call at {FULL}, kernel (plain): {table}; B1 {b1_ms * 1e3:.1f}; "
          f"grid_sample {lib_ms * 1e3:.1f} (max|Δ| {gs_err:.2e} vs B1); "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s")

    # One function, the clamped resample, so one bound for B3-B5.
    bound = _bound(4 * 5 * vox, OPS_CLAMPED_RESAMPLE * vox)

    def numbers(entry, name, group):
        return _numbers(launches[entry], max(err[v] for v in group), ms[name],
                        plain_ms[name], bound, lib_ms)

    return {"run_variant": numbers("run_variant", "v6", rv.KERNELS),
            "run_vmemfull": numbers("run_vmemfull", "vf_fori", (*B45_VARIANTS[:3], *B4_WINDOW)),
            "run_v7": numbers("run_v7", "v7_chunk", (*B45_VARIANTS[3:], *B5_WINDOW))}


def phase13_v10():
    t0 = time.perf_counter()
    v10_xslab.launch_count = 0
    rows = v10_xslab.main(device="cuda")
    launches = v10_xslab.launch_count
    if launches == 0:
        raise AssertionError("v10_xslab.main launched no kernel")
    field, warps = v10_xslab.inputs(FULL, "cuda")
    worst = 0.0
    for tag, _, warp in warps:
        want = v10_xslab.run_v10_reference(field, warp)
        for xb in v10_xslab.XBS:
            got = v10_xslab.run_v10(field, warp, xb)
            worst = max(worst, _close(f"v10 {tag} xb {xb}", got, want, 0.0, 1e-5))
    rfield, rwarp = resample_variants.inputs(RAGGED_X, "cuda")
    worst = max(worst, _close(f"v10 {RAGGED_X} xb 4", v10_xslab.run_v10(
        rfield, rwarp, 4, 64, 20), v10_xslab.run_v10_reference(rfield, rwarp), 0.0, 1e-5))
    random = warps[0][2]
    plain_ms = best_ms(lambda: v10_xslab.run_v10_reference(field, random), field.device, 3)
    gs_call, gs_value = _field_grid_sample(field, resample_variants.clamp_warp(random))
    gs_err = _close("grid_sample vs v10", gs_value(gs_call()),
                    v10_xslab.run_v10(field, random, 8), 0.0, 1e-4)
    lib_ms = best_ms(gs_call, field.device, 20)
    bound = _bound(4 * 5 * field.numel(), OPS_CLAMPED_RESAMPLE * field.numel())
    table = ", ".join(f"{r['warp']} xb {r['xb']} {r['ms_per_call'] * 1e3:.1f}" for r in rows)
    grids = ", ".join(f"xb {xb} {v10_xslab.grids(FULL, xb)}" for xb in v10_xslab.XBS)
    passes = {tag: _sweep.kernel_us(lambda warp=warp: v10_xslab.run_v10(field, warp, 8))
              for tag, _, warp in warps}
    print(f"[13] v10 vs plain at {FULL} (both warps, xb {v10_xslab.XBS}) and {RAGGED_X}: "
          f"max|Δ| {worst:.3e} (tol 1e-5); CTAs (bounds pass, compute pass) at yb 64: "
          f"{grids}; us per call: {table}; device us per pass at xb 8: {passes}; plain "
          f"{plain_ms * 1e3:.0f}; grid_sample {lib_ms * 1e3:.1f} (max|Δ| {gs_err:.2e}); "
          f"random xb 8 bound {bound[0] * 1e3:.1f} ({bound[1]}); launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    xb8 = next(r for r in rows if r["warp"] == "random" and r["xb"] == 8)
    return _numbers(launches, worst, xb8["ms_per_call"], plain_ms, bound, lib_ms)


RAGGED_STACK = (20, 64)  # a ragged (X, Y) for the stack bodies (their Z is 128)


def _exact_all(label, pairs):
    """Hold each (name, kernel, plain) to max|Δ| 0; returns the worst."""
    return max(_close(f"{label} {name}", got(), want(), 0.0, 0.0) for name, got, want in pairs)


def phase14_bisect():
    t0 = time.perf_counter()
    bk = bisect_kernel
    bk.launch_counts.update(dict.fromkeys(bk.launch_counts, 0))
    levels = bk.main(device="cuda")
    v8_rows = bk.main(device="cuda", mode="v8")
    launches = dict(bk.launch_counts)
    if min(launches.values()) == 0:
        raise AssertionError(f"bisect_kernel.main left a kernel unlaunched: {launches}")
    golden_err = max(r["max_abs_err_vs_golden"] for r in v8_rows)
    # Every instantiation equals its plain version on the random stack,
    # whose planes are independent, at 128^3 and at a ragged X.
    err = 0.0
    for shape in (FULL[:2], RAGGED_STACK):
        stacked, warp, field = bk.inputs("cuda", shape)
        err = max(err, _exact_all(f"bisect {shape}", [
            *((f"level {lv}", lambda lv=lv: bk.run(stacked, warp, lv),
               lambda lv=lv: bk.bisect_reference(stacked, warp, lv)) for lv in range(5)),
            *((w, lambda w=w: bk.run_v8(stacked, warp, 64, w),
               lambda w=w: bk.v8_reference(stacked, warp, w)) for w in bk.WHICH)]))
        golden = warp_field(field, resample_variants.clamp_warp(warp))
        golden_err = max(golden_err, _close(f"level 4 {shape} real stack", bk.run(
            bk.make_stack(field), warp, 4), golden, 0.0, 1e-5))
    if not golden_err <= 1e-5:
        raise AssertionError(f"v8 / v8c vs the golden resample: max|Δ| {golden_err:.3e}")
    stacked, warp, _ = bk.inputs("cuda", FULL[:2])
    gs_call, gs_value = _stack_grid_sample(stacked, warp)
    gs_err = _close("grid_sample vs level 4", gs_value(gs_call()),
                    bk.bisect_reference(stacked, warp, 4), 0.0, 1e-3)
    lib_ms = best_ms(gs_call, stacked.device, 20)
    # Level 0 and B9's full/fori are one function on one frame (equal ranges
    # of (tile, x row) steps in one wave, a ring of staged x rows): level 0
    # runs table_kernel's one voxel a thread through pair_sum, B9 loop_kernel's
    # two voxels a thread sharing each pair's offset.
    b9_full_ms = best_ms(lambda: loop_cost.run(stacked, warp, "full", "fori"), stacked.device)
    plain_ms = {
        "level4": best_ms(lambda: bk.bisect_reference(stacked, warp, 4), stacked.device, 3),
        **{w: best_ms(lambda w=w: bk.v8_reference(stacked, warp, w), stacked.device, 3)
           for w in bk.WHICH}}
    ms = {"level4": levels[4]["us_per_call"] / 1e3,
          **{r["which"]: r["us_per_call"] / 1e3 for r in v8_rows if r["yb"] == 64}}
    # Level 4, v8 and v8c are one function, the clamped resample off the stack.
    bound = _bound(_stack_bytes(warp), OPS_CLAMPED_RESAMPLE * warp[..., 0].numel())
    print(f"[14] bisect_kernel at {FULL}: levels us per call "
          f"{[round(r['us_per_call'], 1) for r in levels]} (level 0 {levels[0]['us_per_call']:.1f} "
          f"against B9 full/fori {b9_full_ms * 1e3:.1f} on the same stack); v8/v8c at yb 64, 128 "
          f"{[(r['which'], r['yb'], round(r['us_per_call'], 1)) for r in v8_rows]}; "
          f"every instantiation exact vs plain at {FULL} and X, Y = {RAGGED_STACK} on the "
          f"random stack; level 4, v8, v8c on a real stack vs golden max|Δ| "
          f"{golden_err:.2e} (tol 1e-5); plain us {[round(v * 1e3) for v in plain_ms.values()]}; "
          f"grid_sample {lib_ms * 1e3:.1f} us (max|Δ| {gs_err:.2e} vs level 4); bound "
          f"{bound[0] * 1e3:.1f} us ({bound[1]}); launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    entry = {"level4": "run", "v8": "run_v8", "v8c": "run_v8"}
    return {key: _numbers(launches[entry[key]], err, ms[key], plain_ms[key], bound, lib_ms)
            for key in ms}


B9_SMALL = (3, 12)  # fewer x rows than a ring holds, and a Y off 8-row tiles


def phase15_loop_cost():
    t0 = time.perf_counter()
    lc = loop_cost
    cases = [f"{b}/{lp}" for lp in lc.LOOP_KINDS for b in lc.BODY_KINDS]
    lc.launch_count = 0
    rows = lc.main(device="cuda", cases=cases)
    launches = lc.launch_count
    if launches == 0:
        raise AssertionError("loop_cost.main launched no kernel")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, launched = 0.0, []
    for shape in (FULL[:2], RAGGED_STACK, B9_SMALL):
        stacked, warp = lc.inputs("cuda", shape)
        err = max(err, _exact_all(f"loop_cost {shape}", [
            (case, lambda b=b, lp=lp: lc.run(stacked, warp, b, lp, shape[1]),
             lambda b=b: lc.loop_cost_reference(stacked, warp, b))
            for case, (b, lp, _) in ((c, lc.parse_case(c)) for c in cases)]))
        g = lc.b9_geometry(shape, sms)
        launched.append(f"{shape}: {g['kernel']} x {g['ctas']} CTAs")
    stacked, warp = lc.inputs("cuda", FULL[:2])
    plain_ms = best_ms(lambda: lc.loop_cost_reference(stacked, warp, "full"), stacked.device, 3)
    bound = _bound(_stack_bytes(warp), OPS_B9_FULL * warp[..., 0].numel())
    ms = {r["case"]: r["us_per_call"] / 1e3 for r in rows}
    table = ", ".join(f"{r['case']} {r['us_per_call']:.1f} ({r['us_per_body']:.4f})"
                      for r in rows)
    print(f"[15] loop_cost at {FULL}, us per call (per TPU body): {table}; every "
          f"instantiation exact vs plain at (X, Y) = {FULL[:2]}, {RAGGED_STACK} and "
          f"{B9_SMALL} on the random stack; launched {'; '.join(launched)}; staged "
          f"{lc.b9_staged_bytes(FULL[:2], sms) / 1e6:.1f} MB at {FULL}; full plain "
          f"{plain_ms * 1e3:.0f} us, bound {bound[0] * 1e3:.1f} us ({bound[1]}); "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    return {loop: _numbers(launches, err, ms[f"full/{loop}"], plain_ms, bound, None)
            for loop in lc.LOOP_KINDS}


def _frame_warps(store):
    """A frame callback that keeps each frame's warp on the host."""
    def cb(t, state, warp, report=None, solver=None):
        store[t] = warp.cpu()
    return cb


def _fusion_on_card_and_cpu(seq, config, warps):
    """``config``'s fusion of ``seq`` on the card (pipelined) and on the CPU,
    each frame's warp kept in ``warps["cuda"]``, ``warps["cpu"]``, held to
    each other: per-frame iterations equal; the final warp, and the
    canonical and weights away from voxels whose weight may fall either
    way, within the solve's tolerances (rtol 3e-4, atol 3e-6). A weight
    counts |Φ_w| < 1 - 1e-5: a voxel whose warped value lies closer to that
    bound than the two runs' warped values differ (in some frame) may count
    on one side only; those are counted, at most 1% of the volume. Returns
    (the card's run, its iterations, max|Δ|s, near voxels, their share)."""
    runs = {device: fusion.fuse_sequence(seq.frames, seq.camera, config, device=device,
                                         frame_callback=_frame_warps(warps[device]))
            for device in ("cpu", "cuda")}
    torch.cuda.synchronize()
    ref, got = runs["cpu"], runs["cuda"]
    its = [r.solver_iterations for r in got.reports]
    if its != [r.solver_iterations for r in ref.reports]:
        raise AssertionError(f"iterations {its} != cpu {[r.solver_iterations for r in ref.reports]}")
    bound = np.float32(1.0 - fusion.TRUNCATION_EPS)
    near = torch.zeros(config.grid.shape, dtype=torch.bool)
    for t, warp in warps["cpu"].items():
        live = fusion._tsdf(seq.frames[t], seq.camera, config, torch.device("cpu"))
        want, have = warp_field(live, warp), warp_field(live, warps["cuda"][t])
        near |= torch.abs(torch.abs(want) - float(bound)) <= float(torch.max(torch.abs(have - want)))
    far = ~near
    share = float(near.float().mean())
    if share > 0.01:
        raise AssertionError(f"{share:.2%} of the voxels lie near the band's bound")
    errs = {"warp": _close("fusion final warp", got.final_warp.cpu(), ref.final_warp, 3e-4, 3e-6),
            "canonical": _close("fusion canonical", got.state.canonical.cpu()[far],
                                ref.state.canonical[far], 3e-4, 3e-6),
            "weights": _close("fusion weights", got.state.weights.cpu()[far],
                              ref.state.weights[far], 0.0, 0.0)}
    return got, its, errs, int(near.sum()), share


def phase16_config4_parity():
    """The fusion at tests/test_fusion.py's small size on the card against
    the plain fusion on the CPU (``_fusion_on_card_and_cpu``). Then the
    pipelined loop against the serial loop on the card: reports, states and
    warps equal."""
    release_kept_loops()
    seq = synthetic.snoopy_style_sequence_3d(**C4_SMALL_SEQ)
    warps = {"cpu": {}, "cuda": {}, "serial": {}}
    got, its, errs, near, share = _fusion_on_card_and_cpu(seq, C4_SMALL, warps)
    serial = fusion.fuse_sequence(seq.frames, seq.camera, C4_SMALL, device="cuda",
                                  frame_callback=_frame_warps(warps["serial"]), pipelined=False)
    torch.cuda.synchronize()
    if got.reports != serial.reports:
        raise AssertionError(f"pipelined reports {got.reports} != serial {serial.reports}")
    for a, b in zip((*got.state, got.final_warp, *warps["cuda"].values()),
                    (*serial.state, serial.final_warp, *warps["serial"].values())):
        if not torch.equal(a, b):
            raise AssertionError("the pipelined loop's state or warps differ from the serial loop's")
    print(f"[16] config4 fusion at {C4_SMALL.grid.shape}, {len(seq.frames)} frames, cuda vs cpu: "
          f"iterations {its} equal; max|Δ| {errs} (rtol 3e-4 atol 3e-6) away from "
          f"{near} voxels near the band's bound ({share:.3%}); pipelined == serial "
          f"on cuda (reports, state, every frame's warp)")


class _Stop(Exception):
    """Stops a config4 run after a checkpoint, as an interruption would."""


def _stop_after(frame):
    """``checkpoint.save`` that raises _Stop once it has saved ``frame``."""
    save = checkpoint.save

    def save_then_stop(root, t, *args, **kw):
        path = save(root, t, *args, **kw)
        if t == frame:
            raise _Stop
        return path

    return save, save_then_stop


def _timed_saves(seconds):
    """``checkpoint.save`` that appends each call's host seconds (its
    device-to-host copies, compression and writes) to ``seconds``."""
    save = checkpoint.save

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return path

    return save, timed_save


class _TimedLoop(SolveLoop):
    """A SolveLoop that appends each solve's seconds (host clock; a solve
    ends on a host read of the done flag) to ``seconds``."""

    seconds: list = []

    def solve(self, *args, **kw):
        t0 = time.perf_counter()
        res = super().solve(*args, **kw)
        _TimedLoop.seconds.append(time.perf_counter() - t0)
        return res


def _fusion_split(ds, pipeline_cfg):
    """fuse_sequence alone (no checkpoints) on the config's sequence: the
    frames/s of the pipelined loop from the second fused frame on, and, in
    a serial run, the seconds of fused frames 2 onwards and of their solves
    (the rest is TSDF generation, resample, blend and the stats read)."""
    times = []
    fusion.fuse_sequence(ds.frames, ds.camera, pipeline_cfg, device="cuda",
                         frame_callback=lambda t, s, w: times.append(time.perf_counter()))
    fps = (len(times) - 1) / (times[-1] - times[0])
    # loop_for makes the sequence's loop from single_level's namespace; the
    # loop the run above kept would serve this run instead of a timed one.
    release_kept_loops()
    loop_class, single_level.SolveLoop = single_level.SolveLoop, _TimedLoop
    try:
        _TimedLoop.seconds = []
        stamps = []
        fusion.fuse_sequence(ds.frames, ds.camera, pipeline_cfg, device="cuda", pipelined=False,
                             frame_callback=lambda t, s, w: stamps.append(time.perf_counter()))
    finally:
        single_level.SolveLoop = loop_class
        release_kept_loops()
    # Frame t's solve runs between the callbacks of frames t - 1 and t.
    return fps, stamps[-1] - stamps[0], sum(_TimedLoop.seconds[1:])


def phase17_config4():
    """config4 at full size through the CLI (this slice's main path), the
    kernels' launch counters reset just before; then a run stopped after
    frame C4_STOP's checkpoint and resumed with ``resume=True``, whose final
    state must equal the uninterrupted run's."""
    cfg = PRESETS[C4]
    release_kept_loops()  # the counts below take a new loop's warm-up and capture
    with tempfile.TemporaryDirectory() as root:
        out, stopped = os.path.join(root, "c4"), os.path.join(root, "stopped")
        save_s = []
        save, timed_save = _timed_saves(save_s)
        checkpoint.save = timed_save
        try:
            _reset_launches()
            t0 = time.perf_counter()
            summary = run_experiment(cfg, out, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
        finally:
            checkpoint.save = save
        final = cfg.num_frames - 1
        state, warp, _ = checkpoint.load(os.path.join(out, "checkpoints"), final, "cuda")
        save, save_then_stop = _stop_after(C4_STOP)
        checkpoint.save = save_then_stop
        try:
            run_experiment(cfg, stopped, device="cuda")
            raise AssertionError("the stopped run did not stop")
        except _Stop:
            pass
        finally:
            checkpoint.save = save
        resumed = run_experiment(cfg, stopped, device="cuda", resume=True)
        got_state, got_warp, _ = checkpoint.load(os.path.join(stopped, "checkpoints"), final,
                                                 "cuda")
    ds = cli._sequence_dataset(cfg)
    band0 = int(torch.count_nonzero(torch.abs(generate_tsdf_3d(
        torch.from_numpy(ds.frames[0]).cuda(), ds.camera, _grid(cfg),
        narrow_band_width_voxels=cfg.narrow_band_width_voxels)) < 1))
    reports = summary["reports"]
    its = [r["solver_iterations"] for r in reports]
    bands = [r["band_voxels"] for r in reports]
    want = {"resample": _chunk_launches(its) + len(reports),
            "fused_gradient": _chunk_launches(its), "loop_tail": _chunk_launches(its)}
    pipeline_cfg = fusion.FusionPipelineConfig(
        grid=_grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        hierarchical=False, solver=cfg.solver)
    fps, frames_s, solve_s = _fusion_split(ds, pipeline_cfg)
    print(f"[17] {C4} at {cfg.grid_shape} x {cfg.num_frames} frames on cuda through "
          f"cli.run_experiment: frames_per_s {summary['frames_per_s']}, incl. compile "
          f"{summary['frames_per_s_incl_compile']} (checkpoints every {cfg.checkpoint_every} "
          f"frames inside); iterations {its} ({sum(its)} active, "
          f"{sum(-(-i // CHECK_EVERY) for i in its)} replays of {CHECK_EVERY}); band voxels "
          f"{bands} (frame 0's TSDF: {band0}); max|u| {summary['max_abs_displacement']}; wall "
          f"{wall:.2f} s, of which {len(save_s)} checkpoint saves {sum(save_s):.2f} s "
          f"({', '.join(f'{x:.3f}' for x in save_s)}); launches {launches}; fuse_sequence "
          f"alone: {fps:.2f} frames/s "
          f"pipelined; serial, fused frames 2-{final}: {frames_s * 1e3:.1f} ms, their solves "
          f"{solve_s * 1e3:.1f} ms, outside the solve {1 - solve_s / frames_s:.1%}; resumed "
          f"after frame {C4_STOP}: frames {[r['frame_index'] for r in resumed['reports']]}, "
          f"final state equal")
    numbers = [summary["frames_per_s"], summary["frames_per_s_incl_compile"],
               *summary["max_abs_displacement"], *(r["final_data_energy"] for r in reports)]
    if not all(np.isfinite(numbers)):
        raise AssertionError(f"non-finite results: {numbers}")
    for name, t in (("canonical", state.canonical), ("weights", state.weights), ("warp", warp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"config4 {name} is not finite")
    if float(state.canonical.min()) < -1.0 or float(state.canonical.max()) > 1.0:
        raise AssertionError("config4 canonical leaves [-1, 1]")
    if min(bands) < 0.5 * band0:
        raise AssertionError(f"band voxels {bands} < half of frame 0's {band0}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} for iterations {its}, want {want}")
    if [r["frame_index"] for r in resumed["reports"]] != list(range(C4_STOP + 1, final + 1)):
        raise AssertionError(f"resumed reports {resumed['reports']}")
    for a, b in zip((*got_state, got_warp), (*state, warp)):
        if not torch.equal(a, b):
            raise AssertionError("the resumed run's final state differs from the uninterrupted run's")
    return launches


def _reset_launches():
    resample.launch_count = 0
    fused_gradient.launch_count = 0
    step2d.launch_count = 0
    loop_tail.launch_count = 0
    torch.cuda.synchronize()


def _read_launches():
    """B1's, B2's and the loop tail's launches since ``_reset_launches``
    (the tail's: one an iteration of every ``SolveLoop``, none on the
    sharded solvers' own loops)."""
    torch.cuda.synchronize()
    return {"resample": resample.launch_count, "fused_gradient": fused_gradient.launch_count,
            "loop_tail": loop_tail.launch_count}


def _cli_run(cfg, device):
    """``run_experiment`` into a temporary directory: (summary, wall s)."""
    with tempfile.TemporaryDirectory() as out:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = run_experiment(cfg, out, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return summary, time.perf_counter() - t0


def _level_launches(iterations):
    """A kernel's launches of solves that each ran on their own new
    SolveLoop (a warm-up and a capture each): ``_chunk_launches`` a solve."""
    return sum(_chunk_launches([it]) for it in iterations)


def phase18_config1():
    """config1 (2D, 96 x 48) through ``cli.run_experiment`` on the card with
    the launch counters reset: the iterations of the port's plain run on the
    CPU, converged, the warp within rtol 3e-4 / atol 3e-6 of the CPU's, the
    2D step launched 16 a replay + a warm-up, B1 once (the final resample)
    and B2 never. Then the 2D graph loop against the eager loop
    reading the flag every iteration on the card (exact), both timed in
    turns on the converged solve, and a profiler breakdown of each."""
    cfg = PRESETS[C1]
    grid = _grid(cfg)
    canonical_cpu, live_cpu, _ = _pair_2d(cfg, grid, torch.device("cpu"))
    ref = solve_single_level(canonical_cpu, live_cpu, cfg.solver)
    solves, solve = [], cli.solve_single_level

    def recording(*args, **kw):
        solves.append(solve(*args, **kw))
        return solves[-1]

    cli.solve_single_level = recording
    release_kept_loops()  # the counts below take a new loop's warm-up and capture
    try:
        _reset_launches()
        summary, wall = _cli_run(cfg, "cuda")
        launches = _read_launches()
    finally:
        cli.solve_single_level = solve
    it = summary["iterations"]
    if it != ref.iterations or not summary["converged"]:
        raise AssertionError(f"config1: {it} iterations, converged {summary['converged']}; "
                             f"the CPU run {ref.iterations}")
    err = _close("config1 warp", solves[0].warp.cpu(), ref.warp, 3e-4, 3e-6)
    launches["step2d"] = step2d.launch_count
    want = {"resample": 1, "fused_gradient": 0, "step2d": _chunk_launches([it]),
            "loop_tail": _chunk_launches([it])}
    if launches != want or summary["kernel_launches"] != want:
        raise AssertionError(f"config1 launches {launches} (summary.json: "
                             f"{summary['kernel_launches']}) for {it} iterations, want {want}")
    numbers = [summary["residual_before"], summary["residual_after"], *summary["max_abs_displacement"]]
    if not all(np.isfinite(numbers)) or not summary["residual_reduction"] >= 2.0:
        raise AssertionError(f"config1 summary {summary}")
    canonical, live = canonical_cpu.cuda(), live_cpu.cuda()
    loops = {"serial": SolveLoop(CONFIG1, cfg.solver, "cuda", **SERIAL),
             "graph": SolveLoop(CONFIG1, cfg.solver, "cuda")}
    first = {mode: loop.solve(canonical, live) for mode, loop in loops.items()}
    torch.cuda.synchronize()
    got, exp = first["graph"], first["serial"]
    diffs = {"iterations": abs(got.iterations - exp.iterations),
             "warp": _max_diff(got.warp, exp.warp),
             "telemetry": max(_max_diff(a, b) for a, b in zip(got.telemetry, exp.telemetry)),
             "max|u|": _max_diff(got.max_abs_displacement, exp.max_abs_displacement),
             "rate": abs(float(loops["graph"].rate) - float(loops["serial"].rate))}
    if any(diffs.values()):
        raise AssertionError(f"config1: the graph loop differs from the eager loop: {diffs}")
    _check_capture(loops["graph"], CHECK_EVERY)
    runs = {"serial": [], "graph": []}
    for mode in ("graph", "serial", "serial", "graph"):
        runs[mode].append(_solve_ms(loops[mode], canonical, live))
    graph_ms, serial_ms = min(runs["graph"]), min(runs["serial"])
    short = cfg.solver.replace(max_iterations=PROFILE_ITERS, convergence_threshold=0.0)
    profiles = [_profile_solve(SolveLoop(CONFIG1, short, "cuda", **kw), canonical, live,
                               ms / it * 1e3, label, where=f"config1 solve at {CONFIG1}")
                for label, kw, ms in (("graph", {}, graph_ms), ("serial", SERIAL, serial_ms))]
    print(f"[18] {C1} at {CONFIG1} on cuda through cli.run_experiment: iterations {it} (cpu "
          f"{ref.iterations}; {-(-it // CHECK_EVERY)} replays of {CHECK_EVERY}), converged, "
          f"residual {summary['residual_before']:.6f} -> {summary['residual_after']:.6f} "
          f"(reduction {summary['residual_reduction']:.4f}), warp max|Δ| vs cpu {err:.3e} "
          f"(rtol 3e-4 atol 3e-6), wall {wall * 1e3:.1f} ms (capture included), launches "
          f"{launches}; graph loop == eager loop on cuda (max|Δ| 0); converged solve: graph "
          f"{graph_ms:.2f} ms, {graph_ms / it * 1e3:.1f} us/iter, eager (flag read every "
          f"iteration) {serial_ms:.2f} ms, {serial_ms / it * 1e3:.1f} us/iter, "
          f"{serial_ms / graph_ms:.2f}x (runs graph, serial, serial, graph: "
          f"{[round(v, 2) for v in (runs['graph'][0], *runs['serial'], runs['graph'][1])]} ms)")
    for profile in profiles:
        print(f"[18] {profile}")
    return launches


def phase19_config2():
    """config2 (2D, 96 x 64, 3 levels, Sobolev) through the CLI with its
    EWA depth pyramid, and once with the block-mean pyramid: per-level
    iterations equal to the CPU run's, residuals within rtol 1e-3 of it,
    the 2D step launched by each level's new loop (a warm-up, 16 a replay)
    and B1 by the final resample."""
    lines, total = [], {"resample": 0, "fused_gradient": 0, "step2d": 0, "loop_tail": 0}
    for method in ("ewa_depth", "block_mean"):
        cfg = dataclasses.replace(PRESETS[C2], pyramid_method=method)
        cpu, _ = _cli_run(cfg, "cpu")
        release_kept_loops()  # each level's new loop: a warm-up and a capture
        _reset_launches()
        summary, wall = _cli_run(cfg, "cuda")
        launches = {**_read_launches(), "step2d": step2d.launch_count}
        its = summary["iterations_per_level"]
        if its != cpu["iterations_per_level"]:
            raise AssertionError(f"config2 {method}: iterations {its}, cpu "
                                 f"{cpu['iterations_per_level']}")
        for key in ("residual_before", "residual_after"):
            _close(f"config2 {method} {key}", torch.tensor(summary[key]), torch.tensor(cpu[key]),
                   1e-3, 0.0)
        want = {"resample": 1, "fused_gradient": 0, "step2d": _level_launches(its),
                "loop_tail": _level_launches(its)}
        if launches != want or summary["kernel_launches"] != want:
            raise AssertionError(f"config2 {method} launches {launches} (summary.json: "
                                 f"{summary['kernel_launches']}), want {want}")
        total = {k: total[k] + launches[k] for k in total}
        lines.append(f"{method}: iterations per level {its} (cpu equal), converged "
                     f"{summary['converged']}, residual {summary['residual_before']:.6f} -> "
                     f"{summary['residual_after']:.6f} (reduction "
                     f"{summary['residual_reduction']:.4f}; cpu {cpu['residual_reduction']:.4f}), "
                     f"wall {wall * 1e3:.1f} ms (3 captures included), launches {launches}")
    print(f"[19] {C2} at {PRESETS[C2].grid_shape} on cuda through cli.run_experiment: "
          f"{'; '.join(lines)}")
    return total


def phase20_rigid():
    """rigid_2d and rigid_3d through the CLI on the card: pose error <= 2e-3
    (tests/test_rigid.py's bound) and the estimate within 1e-4 of the CPU
    run's; then each solve's 30 Gauss-Newton steps with CUDA's sync debug
    mode set to raise: no step reads a value back to the host."""
    lines = []
    for name in RIGID:
        cfg = PRESETS[name]
        cpu, _ = _cli_run(cfg, "cpu")
        summary, wall = _cli_run(cfg, "cuda")
        diff = float(np.max(np.abs(np.subtract(summary["estimated_extrinsic"],
                                               cpu["estimated_extrinsic"]))))
        if not summary["pose_error"] <= 2e-3 or diff > 1e-4:
            raise AssertionError(f"{name}: pose error {summary['pose_error']}, estimate "
                                 f"{diff} from the cpu's")
        if not np.isfinite([summary["initial_energy"], summary["final_energy"]]).all():
            raise AssertionError(f"{name}: energies {summary}")
        lines.append(f"{name} pose error {summary['pose_error']:.3e} (cpu {cpu['pose_error']:.3e}), "
                     f"estimate max|Δ| vs cpu {diff:.2e}, energy {summary['initial_energy']:.4f} "
                     f"-> {summary['final_energy']:.3e}, wall {wall * 1e3:.1f} ms")
    pair = synthetic.bump_wall_pair_2d(width=128, bump_height=0.04, live_shift_px=0.0)
    depth2 = torch.from_numpy(pair.canonical_depth).cuda()
    grid2 = _grid(PRESETS["rigid_2d"])
    canonical2 = generate_tsdf_2d(depth2, pair.camera, grid2)
    depth_np, cam = cli._rigid_depth_3d(PRESETS["rigid_3d"])
    depth3 = torch.from_numpy(depth_np).cuda()
    grid3 = _grid(PRESETS["rigid_3d"])
    canonical3 = generate_tsdf_3d(depth3, cam, grid3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solve_rigid_2d(canonical2, depth2, pair.camera, grid2)
        solve_rigid_3d(canonical3, depth3, cam, grid3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[20] rigid through cli.run_experiment on cuda: {'; '.join(lines)}; both solves "
          f"enqueue their 30 steps with no host read (sync debug mode 'error')")


class _CountingLoop(SolveLoop):
    """A SolveLoop that keeps every instance and each solve's iterations."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.solved = []
        _CountingLoop.made.append(self)

    def solve(self, *args, **kw):
        res = super().solve(*args, **kw)
        self.solved.append(res.iterations)
        return res


def _fps(frames, camera, config):
    """fuse_sequence alone of ``frames`` (a list or a frame source) on the
    card: (result, frames/s from the second fused frame on, as the CLI
    counts it)."""
    stamps = []
    result = fusion.fuse_sequence(frames, camera, config, device="cuda",
                                  frame_callback=lambda t, s, w: stamps.append(time.perf_counter()))
    return result, (len(stamps) - 1) / (stamps[-1] - stamps[0])


def phase21_hierarchical_fusion():
    """The hierarchical fusion (3 levels): at (32, 32, 24) x 4 frames on the
    card against the CPU (phase 16's rules); at 128³ x 8 frames on config4's
    sequence through ``fuse_sequence``, phase 17's checks, exactly 3 graph
    captures (one loop per level shape), each capture recording 16 calls of
    B1 and of B2, each loop replaying one chunk for every 16 iterations its
    solves began, B1 and B2 launched as ``_chunk_launches`` of each level's
    solved iterations (+ B1's blend resample a frame), frames/s beside the
    flat path's in the same run. Then the three EWA methods of TSDF generation at 128³,
    card against CPU, timed."""
    seq = synthetic.snoopy_style_sequence_3d(**C4_SMALL_SEQ)
    _, small_its, errs, near, share = _fusion_on_card_and_cpu(
        seq, C4_SMALL_HIER, {"cpu": {}, "cuda": {}})
    cfg = PRESETS[C4]
    ds = cli._sequence_dataset(cfg)
    flat_cfg = fusion.FusionPipelineConfig(
        grid=_grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        hierarchical=False, solver=cfg.solver)
    hier_cfg = dataclasses.replace(flat_cfg, hierarchical=True)
    # Three new counting loops: none kept by an earlier run serves this one,
    # and none of them serves the runs after it.
    release_kept_loops()
    loop_class, single_level.SolveLoop = single_level.SolveLoop, _CountingLoop
    try:
        _CountingLoop.made = []
        _reset_launches()
        result, fps = _fps(ds.frames, ds.camera, hier_cfg)
        launches = {**_read_launches(), "step2d": step2d.launch_count}
    finally:
        single_level.SolveLoop = loop_class
        release_kept_loops()
    _, flat_fps = _fps(ds.frames, ds.camera, flat_cfg)
    hier_again, hier_fps2 = _fps(ds.frames, ds.camera, hier_cfg)
    loops = _CountingLoop.made
    captures = sum(loop.graph_launches is not None for loop in loops)  # at most one a loop
    band0 = int(torch.count_nonzero(torch.abs(generate_tsdf_3d(
        torch.from_numpy(ds.frames[0]).cuda(), ds.camera, _grid(cfg),
        narrow_band_width_voxels=cfg.narrow_band_width_voxels)) < 1))
    bands = [r.band_voxels for r in result.reports]
    per_level = {tuple(loop.shape): loop.solved for loop in loops}
    b2 = sum(_chunk_launches(loop.solved) for loop in loops)
    want = {"resample": b2 + len(result.reports), "fused_gradient": b2, "step2d": 0,
            "loop_tail": b2}
    state = result.state
    for name, t in (("canonical", state.canonical), ("weights", state.weights),
                    ("warp", result.final_warp)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"hierarchical fusion {name} is not finite")
    if float(state.canonical.min()) < -1.0 or float(state.canonical.max()) > 1.0:
        raise AssertionError("hierarchical fusion canonical leaves [-1, 1]")
    if min(bands) < 0.5 * band0:
        raise AssertionError(f"band voxels {bands} < half of frame 0's {band0}")
    if captures != 3 or len(loops) != 3:
        raise AssertionError(f"{captures} graph captures, {len(loops)} loops; want 3 and 3")
    for loop in loops:
        _check_capture(loop, CHECK_EVERY)
        if loop.replays != sum(-(-it // CHECK_EVERY) for it in loop.solved):
            raise AssertionError(f"the loop at {loop.shape} replayed {loop.replays} chunks "
                                 f"for solves of {loop.solved} iterations")
    if launches != want or not all(loop.replays for loop in loops):
        raise AssertionError(f"hierarchical fusion launches {launches}, want {want}")
    if hier_again.reports != result.reports:
        raise AssertionError("a second hierarchical run reports otherwise")
    print(f"[21] hierarchical fusion (3 levels) at {C4_SMALL.grid.shape} x "
          f"{len(seq.frames)} frames, cuda vs cpu: iterations {small_its} equal; max|Δ| {errs} "
          f"(rtol 3e-4 atol 3e-6) away from {near} voxels near the band's bound ({share:.3%})")
    print(f"[21] hierarchical fusion of {C4}'s sequence at {cfg.grid_shape} x {cfg.num_frames} "
          f"frames on cuda through fuse_sequence: {fps:.2f} and {hier_fps2:.2f} frames/s (flat "
          f"path in the same run: {flat_fps:.2f}); iterations per level shape {per_level} "
          f"(finest as reported: {[r.solver_iterations for r in result.reports]}); band voxels "
          f"{bands} (frame 0's TSDF: {band0}); {captures} graph captures, replays "
          f"{[loop.replays for loop in loops]}; launches {launches}")
    depths = {device: torch.from_numpy(ds.frames[0]).to(device) for device in ("cpu", "cuda")}
    lines = []
    for method in (GenerationMethod.BASIC, *EWA):
        def gen(device, method=method):
            return generate_tsdf_3d(depths[device], ds.camera, _grid(cfg),
                                    narrow_band_width_voxels=cfg.narrow_band_width_voxels,
                                    method=method)
        got, ref = gen("cuda"), gen("cpu")
        diff = torch.abs(got.cpu() - ref)
        off = float((diff > 1e-5).float().mean())
        if off > 0.005:
            raise AssertionError(f"TSDF {method.value}: {off:.3%} of voxels off the cpu's by > 1e-5")
        ms = _time_ms(lambda: gen("cuda"), 5)
        lines.append(f"{method.value} {ms:.3f} ms (max|Δ| {float(diff.max()):.2e}, {off:.4%} "
                     f"> 1e-5)")
    print(f"[21] TSDF generation at {cfg.grid_shape} from a {ds.camera.image_width}x"
          f"{ds.camera.image_height} depth image on cuda vs cpu: {'; '.join(lines)}")
    return launches



C5, C5_512 = "config5_sharded", "config5_512"
C5_512_SHAPE = (512, 512, 512)
# Phase 22's splits: (the preset whose solver's terms and halos the calls
# take, the volume, ranks). 128³ / 4 and config5_512's 512³ / 8 (blocks of
# (64, 512, 512)) hold interior and edge ranks. A world of 1 is what phases
# 23 and 24 run: one block with both global edges, B1 on X + 2 live_halo
# rows and B2's window of X rows on X + 2 stencil_halo, at config5_512's
# 512³, config5_sharded's (128, 64, 128) and the sharded fusion's (config4)
# 128³. Ghost rows beyond a global edge hold garbage, which the windowed B2
# must never read (B1's live halo holds the +1 fill there).
WINDOW_SPLITS = ((C5_512, FULL, 4), (C5_512, C5_512_SHAPE, 8),
                 (C5_512, C5_512_SHAPE, 1), (C5, PRESETS[C5].grid_shape, 1),
                 (C4, PRESETS[C4].grid_shape, 1))
WINDOW_GHOST = 7.7


def _device_fields(shape, seed, warp_scale):
    """``_fields`` made on the card from a seeded generator (a 512³ volume
    takes seconds in numpy)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(shape, generator=gen, device="cuda")
    canonical = torch.tanh(base * 0.4)
    warped = torch.tanh(torch.roll(base, 1, 0) * 0.4)
    warp = torch.randn((3, *shape), generator=gen, device="cuda") * warp_scale
    return canonical, warped, warp


def _haloed(a, rank, n_local, halo, fill, axis=0):
    """Rank ``rank``'s block of ``n_local`` rows along ``axis`` with ``halo``
    rows a side, ``fill`` beyond the volume's edges."""
    pad = [0, 0] * (a.ndim - 1 - axis) + [halo, halo]
    ext = F.pad(a[None], pad, value=fill)[0] if halo else a
    return ext.narrow(axis, rank * n_local, n_local + 2 * halo).contiguous()


def _split_name(preset, shape, world):
    return f"{preset} {tuple(shape)} / {world}"


def phase22_windows():
    """B1 with ``x_start`` and B2 with its x window on every rank's haloed
    block of each of ``WINDOW_SPLITS``, with the split's preset's energy
    terms, stencil halo and live halo (at most a block): each held to its
    plain version (B1 exactly, B2's warp within 4.8e-7), and the union of
    the ranks' windows to the whole-volume kernel call (B2's warp rows
    within 4.8e-7; the summed energies and sum|δu| within rel 1e-5, the
    maxes exactly). Then one windowed B2 call and one B1 call at
    config5_512's 8-way shard, timed beside their plain versions, B1 also
    beside one ``grid_sample`` of the haloed field, with their bounds.
    Returns the worst max|Δ|s, those of each split, and the shard's
    numbers."""
    rate = torch.tensor(0.3, device="cuda")
    worst = {"resample": 0.0, "fused": 0.0, "union": 0.0}
    by_split = {}
    timing = None
    for seed, (preset, shape, world) in enumerate(WINDOW_SPLITS, 40):
        p = PRESETS[preset]
        hx, kw = p.solver.stencil_halo, single_level.fused_step_kwargs(p.solver)
        canonical, warped, warp = _device_fields(shape, seed, 0.8)
        nl = shape[0] // world
        lh = min(p.live_halo, nl)
        whole_w, whole_s = fused_gradient_update(warped, canonical, warp, rate, **kw)
        sums = torch.zeros(8, dtype=torch.float64, device="cuda")
        maxes = torch.zeros(4, device="cuda")
        errs = {"resample": 0.0, "fused": 0.0, "union": 0.0}
        for rank in range(world):
            # B1: the rank's warp block from the live block with its halo.
            live_ext = _haloed(warped, rank, nl, lh, 1.0)
            warp_blk = warp.narrow(1, rank * nl, nl).contiguous()
            got = warp_field_cm(live_ext, warp_blk, x_start=lh)
            torch.cuda.synchronize()
            want = warp_field_cm_reference(live_ext, warp_blk, x_start=lh)
            errs["resample"] = max(errs["resample"], _close(
                f"resample x_start {shape} rank {rank}", got, want, 0.0, 0.0))
            del got, want
            # B2: the rank's window of the haloed block.
            blocks = [_haloed(a, rank, nl, hx, WINDOW_GHOST, axis)
                      for a, axis in ((warped, 0), (canonical, 0), (warp, 1))]
            win = dict(x_offset=rank * nl - hx, x_global=shape[0], x_lo=hx, x_len=nl)
            got = fused_gradient_update(*blocks, rate, **kw, **win)
            torch.cuda.synchronize()
            want = fused_gradient_update_reference(*blocks, rate, **kw, **win)
            errs["fused"] = max(errs["fused"], _check_fused(
                f"windowed fused {shape} rank {rank}", got, want, rtol=0.0, atol=4.8e-7))
            del want
            errs["union"] = max(errs["union"], _close(
                f"windowed fused {shape} rank {rank} vs the whole call", got[0],
                whole_w.narrow(1, rank * nl, nl), 0.0, 4.8e-7))
            sums[:4] += got[1][:4].double()
            maxes = torch.maximum(maxes, got[1][4:])
            if (preset, shape, world) == (C5_512, C5_512_SHAPE, 8) and rank == 1:
                timing = (live_ext, warp_blk, blocks, win, kw, lh)
            del got, blocks, live_ext, warp_blk
        _close(f"windowed fused {shape}: summed energies and sum|du|", sums[:4],
               whole_s[:4].double(), 1e-5)
        _close(f"windowed fused {shape}: maxes", maxes, whole_s[4:], 0.0)
        by_split[_split_name(preset, shape, world)] = errs
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        del canonical, warped, warp, whole_w
        torch.cuda.empty_cache()
    live_ext, warp_blk, blocks, win, kw, lh = timing
    b1_call = lambda: warp_field_cm(live_ext, warp_blk, x_start=lh)  # noqa: E731
    b2_call = lambda: fused_gradient_update(*blocks, rate, **kw, **win)  # noqa: E731
    # B1's yardstick: one grid_sample of the haloed field at (x_start + i +
    # ux, j + uy, k + uz), its grid built outside the timed call, held to B1
    # within 1e-4 (normalised coordinates).
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device="cuda") for n in warp_blk.shape[1:]),
        indexing="ij"), dim=-1)
    idx[..., 0] += lh
    gs_call, gs_value = _grid_sample(live_ext[None], (idx + warp_blk.movedim(0, -1))[None])
    gs_err = _close("grid_sample vs windowed B1", gs_value(gs_call())[0], b1_call(), 0.0, 1e-4)
    del idx
    b1 = [_time_ms(b1_call, 20)]
    b1_lib = [_time_ms(gs_call, 20)]
    b1_plain = _time_ms(lambda: warp_field_cm_reference(live_ext, warp_blk, x_start=lh), 3)
    b1.append(_time_ms(b1_call, 20))
    b1_lib.append(_time_ms(gs_call, 20))
    b2 = [_time_ms(b2_call, 20)]
    b2_plain = _time_ms(lambda: fused_gradient_update_reference(*blocks, rate, **kw, **win), 3)
    b2.append(_time_ms(b2_call, 20))
    plane = warp_blk[0, 0].numel()
    out_vox = warp_blk[0].numel()
    # The field rows B1 must read: those the warp's x extent reaches (each
    # sample's two corner rows), inside the field.
    x = (torch.arange(warp_blk.shape[1], dtype=torch.float32, device="cuda")[:, None, None]
         + warp_blk[0] + lh)
    lo = max(0, int(torch.floor(torch.min(x))))
    hi = min(live_ext.shape[0], int(torch.floor(torch.max(x))) + 2)
    b1_bound = _bound(4 * ((hi - lo) * plane + 4 * out_vox), OPS_RESAMPLE * out_vox)
    b2_bound = _bound(4 * (5 * blocks[0].numel() + 3 * win["x_len"] * plane),
                      OPS_FUSED * win["x_len"] * plane)
    shard = {"resample": (min(b1), b1_plain, b1_bound, tuple(live_ext.shape), min(b1_lib)),
             "fused_gradient": (min(b2), b2_plain, b2_bound, tuple(blocks[0].shape), None)}
    print(f"[22] windows on every rank of {list(by_split)}: B1 x_start = live halo vs plain "
          f"max|Δ| {worst['resample']} (exact); B2 x window (ghosts {WINDOW_GHOST}) vs plain "
          f"warp max|Δ| {worst['fused']:.3e} (atol 4.8e-7), union of the windows vs the "
          f"whole call {worst['union']:.3e}; by split {by_split}")
    print(f"[22] at config5_512's shard: B1 field {shard['resample'][3]} -> "
          f"{tuple(warp_blk.shape[1:])} {[round(t * 1e3, 1) for t in b1]} us (plain "
          f"{b1_plain * 1e3:.1f} us, grid_sample {[round(t * 1e3, 1) for t in b1_lib]} us, "
          f"max|Δ| {gs_err:.2e} vs B1; bound {b1_bound[0] * 1e3:.1f} us for field rows "
          f"[{lo}, {hi}) of {live_ext.shape[0]}), B2 {shard['fused_gradient'][3]} window "
          f"{win['x_len']} rows {[round(t * 1e3, 1) for t in b2]} us (plain "
          f"{b2_plain * 1e3:.1f} us, bound {b2_bound[0] * 1e3:.1f} us)")
    return worst, by_split, shard


class _ShardedLoop:
    """The sharded solve on a group as a loop object, for ``_solve_ms`` and
    ``_profile_solve``."""

    def __init__(self, params, group, live_halo):
        self.params, self.group, self.live_halo = params, group, live_halo

    def solve(self, canonical, live):
        return solve_single_level_sharded(canonical, live, self.params, group=self.group,
                                          live_halo=self.live_halo)


def _sharded_launches(iterations):
    """B1's and B2's launches of a sharded_3d run: one each an iteration,
    and B1's final resample of the live field; its own loop runs no loop
    tail."""
    return {"resample": iterations + 1, "fused_gradient": iterations, "loop_tail": 0}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _steps(summary):
    """A sharded run's iterations: per level where it has levels."""
    return summary.get("iterations_per_level") or summary["iterations"]


def _ranks(cfg, one_rank, world=2, equal=True):
    """``cfg`` through the CLI on ``world`` NCCL ranks (processes with
    torchrun's environment, one device each), held to the run on one rank:
    iterations and ``converged`` equal, the residuals within rel 1e-4 and
    max|u| within rtol 3e-4. With ``equal`` false (the Schur solvers, whose
    result depends on the cuts) it only has to converge as the one rank's
    run does and reduce the residual."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "config.in.json")
        with open(path, "w") as f:
            f.write(cfg.to_json())
        procs = [subprocess.Popen(
            [sys.executable, "-m", "levelsetfusion_tpu_torch.cli", "--config", path,
             "--out", out],
            env={**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r)},
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise AssertionError(f"the {world}-rank run failed: {[e[-2000:] for e in errs]}")
        with open(os.path.join(out, "summary.json")) as f:
            two = json.load(f)
    name = f"{cfg.name} (mesh {cfg.mesh_shape}) on {world} NCCL ranks"
    if two["devices"] != world or two["converged"] != one_rank["converged"]:
        raise AssertionError(f"{name}: {two} against 1 rank: {one_rank}")
    if not equal:
        if two["residual_after"] >= two["residual_before"] or two["contract_violations"]:
            raise AssertionError(f"{name}: {two}")
        return (f"{name}: {two['iterations']} steps (1 rank: {one_rank['iterations']}), "
                f"residual_after {two['residual_after']:.6g} (1 rank: "
                f"{one_rank['residual_after']:.6g}), wall {two['wall_seconds']} s")
    if _steps(two) != _steps(one_rank):
        raise AssertionError(f"{name}: {two} against 1 rank: {one_rank}")
    for key in ("residual_before", "residual_after"):
        _close(f"{name} {key}", torch.tensor(two[key]), torch.tensor(one_rank[key]), 1e-4)
    _close(f"{name} max|u|", torch.tensor(two["max_abs_displacement"]),
           torch.tensor(one_rank["max_abs_displacement"]), 3e-4)
    return (f"{name}: {_steps(two)} iterations, "
            f"residual_after {two['residual_after']:.6g}, wall {two['wall_seconds']} s, "
            "equal to 1 rank's")


def phase23_sharded():
    """``sharded_3d`` through ``cli.run_experiment`` on a world of 1 (NCCL),
    the launch counters reset just before each run: config5_sharded
    (iterations, converged; its warp from the same solve on the group
    against the single-device port on the card at atol 2e-5 / rtol 1e-4,
    the JAX parity test's; B1 and B2 once an iteration, B1 once more for the
    final resample), and config5_512 at 512³ (Killing + level set + Sobolev,
    k = 4), its peak memory. Then config5_512's solve timed on its own
    (µs/iter, voxel·iter/s, peak memory) and a ``torch.profiler`` breakdown
    of 8 of its iterations. With two devices, config5_sharded on 2 NCCL
    ranks against 1."""
    paths, out = {}, {}
    for name in (C5, C5_512):
        cfg = PRESETS[name]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        summary, wall = _cli_run(cfg, "cuda")
        paths[name] = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if paths[name] != _sharded_launches(summary["iterations"]):
            raise AssertionError(f"{name}: launches {paths[name]} for {summary['iterations']} "
                                 "iterations")
        numbers = [summary[k] for k in ("residual_before", "residual_after")]
        if not all(np.isfinite(numbers + summary["max_abs_displacement"])):
            raise AssertionError(f"{name}: non-finite results {summary}")
        if (summary["residual_after"] >= summary["residual_before"]
                or summary["contract_violations"]):
            raise AssertionError(f"{name}: {summary}")
        out[name] = (summary, wall, peak)
    c5, _, _ = out[C5]
    if not c5["converged"]:
        raise AssertionError(f"{C5} did not converge in {c5['iterations']} iterations")
    group = init_group("cuda")
    try:
        cfg = PRESETS[C5]
        canonical, live = _pair_3d(cfg, _grid(cfg), group.device)
        sh = solve_single_level_sharded(canonical, live, cfg.solver, group=group,
                                        live_halo=cfg.live_halo)
        single = solve_single_level(canonical, live, cfg.solver)
        if not sh.iterations == single.iterations == c5["iterations"]:
            raise AssertionError(f"{C5}: sharded {sh.iterations}, single-device "
                                 f"{single.iterations}, CLI {c5['iterations']} iterations")
        warp_err = _close(f"{C5} warp vs the single-device port", sh.warp, single.warp,
                          1e-4, 2e-5)
        c5_loop = _ShardedLoop(cfg.solver, group, cfg.live_halo)
        c5_ms = [_solve_ms(c5_loop, canonical, live) for _ in range(2)]
        c5_rate = canonical.numel() * sh.iterations / (min(c5_ms) / 1e3)
        single_loop = SolveLoop(canonical.shape, cfg.solver, group.device)
        single_loop.solve(canonical, live)
        c5_single_ms = _solve_ms(single_loop, canonical, live)
        cfg = PRESETS[C5_512]
        canonical, live = _pair_3d(cfg, _grid(cfg), group.device)
        loop = _ShardedLoop(cfg.solver, group, cfg.live_halo)
        res = loop.solve(canonical, live)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [_solve_ms(loop, canonical, live) for _ in range(2)]
        solve_peak = torch.cuda.max_memory_allocated() / 2**30
        per_iter_ms = min(runs) / res.iterations
        rate = canonical.numel() / (per_iter_ms / 1e3)
        short = _ShardedLoop(cfg.solver.replace(max_iterations=8, convergence_threshold=0.0),
                             group, cfg.live_halo)
        profile = _profile_solve(short, canonical, live, per_iter_ms * 1e3, "eager sharded",
                                 where=f"{C5_512} solve at {C5_512_SHAPE}, world 1")
    finally:
        close_group(group)
    if torch.cuda.device_count() >= 2:
        multi = _ranks(PRESETS[C5], c5)
    else:
        multi = (f"the multi-rank run needs a second device: this process sees "
                 f"{torch.cuda.device_count()}")
    s512, wall512, peak512 = out[C5_512]
    print(f"[23] sharded_3d on a world of 1 (NCCL) through cli.run_experiment: {C5} "
          f"{PRESETS[C5].grid_shape}: {c5['iterations']} iterations, converged, residual "
          f"{c5['residual_before']:.6g} -> {c5['residual_after']:.6g}, max|u| "
          f"{[round(v, 4) for v in c5['max_abs_displacement']]}, wall {out[C5][1]:.2f} s, "
          f"launches {paths[C5]}; its warp vs the single-device port on the card max|Δ| "
          f"{warp_err:.3e} (atol 2e-5 rtol 1e-4, {single.iterations} iterations both); its "
          f"solve {min(c5_ms):.1f} ms (runs {[round(r, 2) for r in c5_ms]}), "
          f"{min(c5_ms) / sh.iterations * 1e3:.1f} us/iter, {c5_rate:.4e} voxel*iter/s (the "
          f"single-device graph loop's {c5_single_ms:.1f} ms); "
          f"{C5_512} {C5_512_SHAPE}: {s512['iterations']} iterations (k = "
          f"{PRESETS[C5_512].solver.termination_check_interval}), converged "
          f"{s512['converged']}, residual {s512['residual_before']:.6g} -> "
          f"{s512['residual_after']:.6g}, wall {wall512:.2f} s, launches {paths[C5_512]}, "
          f"peak memory {peak512:.2f} GiB; its solve alone {min(runs):.1f} ms "
          f"(runs {[round(r, 2) for r in runs]} ms), {per_iter_ms * 1e3:.1f} us/iter, "
          f"{rate:.4e} voxel*iter/s, peak memory {solve_peak:.2f} GiB")
    print(f"[23] {profile}")
    print(f"[23] {multi}")
    return paths, {"config5_512_us_per_iter": per_iter_ms * 1e3, "voxel_iter_per_s": rate,
                   "peak_gib": solve_peak}


def phase24_sharded_fusion():
    """``multi_frame_sharded_3d``'s fusion on a world of 1 (NCCL): config4's
    128³ x 8 sequence through ``fuse_sequence_sharded``, the launch counters
    reset just before, held frame by frame to the single-device frame
    (``fusion.fuse_frame``, what ``fuse_sequence`` runs) from the same state
    and warm start, by phase 16's rules at the tolerance of the JAX
    package's sharded-fusion test (tests/test_fusion_sharded.py: atol 2e-5,
    rtol 1e-4): iterations equal; the warp, and the canonical and weights
    away from voxels whose weight may fall either way (at most 1% of the
    volume). A voxel's weight may fall either way where its two warped
    values lie closer to the bound than to each other. The block's resample
    samples at float(x_start + i) + u, not float(x) + u, and a warped value
    that this moves across the band's bound changes the data term there
    inside a solve: at 128³ that moves a frame's warp past phase 16's 3e-6
    (PERF.md §6). The witness shows it: each frame solved and blended on the
    group with no live halo (x_start 0) is held to phase 16's rules.
    Frame by frame, since a weight that falls the other way changes the next
    frames' canonical there: the free-running runs' per-frame iterations are
    held equal and their warps' differences printed. Frames/s of both from
    the second fused frame on."""
    cfg = PRESETS[C4]
    ds = cli._sequence_dataset(cfg)
    pipeline_cfg = fusion.FusionPipelineConfig(
        grid=_grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        hierarchical=False, solver=cfg.solver)
    after = {}  # frame -> (state, warp) of the sharded run
    stamps = []

    def keep(t, state, warp, report=None, solver=None):
        after[t] = (fusion.FusionState(*(a.clone() for a in state)), warp.clone())
        stamps.append(time.perf_counter())

    group = init_group("cuda")
    try:
        _reset_launches()
        got = fusion.fuse_sequence_sharded(ds.frames, ds.camera, pipeline_cfg, group=group,
                                           live_halo=cfg.live_halo, frame_callback=keep)
        launches = _read_launches()
        errs, near_max, witness, witness_near, free, its, flat_fps = _hold_sharded_frames(
            ds, pipeline_cfg, got, after, group, cfg.live_halo)
    finally:
        close_group(group)
    fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    want = {"resample": sum(its) + len(its), "fused_gradient": sum(its), "loop_tail": 0}
    if launches != want:
        raise AssertionError(f"sharded fusion launches {launches}, want {want}")
    if any(r.contract_violations for r in got.reports):
        raise AssertionError(f"live-halo violations {[r.contract_violations for r in got.reports]}")
    print(f"[24] {C4} at {cfg.grid_shape} x {len(ds.frames)} frames through "
          f"fuse_sequence_sharded on a world of 1 (NCCL): iterations {its}, as fuse_sequence's; "
          f"each frame vs fuse_frame on the card from the same state: max|Δ| "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (rtol 1e-4 atol 2e-5) away from "
          f"voxels near the band's bound (at most {near_max:.3%} a frame); with no live halo "
          f"(x_start 0) max|Δ| { {k: f'{v:.3e}' for k, v in witness.items()} } (rtol 3e-4 "
          f"atol 3e-6) away from {witness_near:.3%} near voxels; the free-running "
          f"runs' warps by frame max|Δ| {[f'{e:.2e}' for e in free]}; launches {launches}; "
          f"{fps:.2f} frames/s sharded (eager loop), {flat_fps:.2f} frames/s flat (graph "
          f"loop, pipelined)")
    return launches


def _hold_sharded_frames(ds, pipeline_cfg, got, after, group, live_halo):
    """Phase 24's checks of the sharded run ``got`` (``after``: each frame's
    state and warp) against the single-device fusion: the free-running
    ``fuse_sequence``'s iterations, then each frame against ``fuse_frame``
    from the sharded run's state before it. A voxel is near the bound where
    the two paths' blend values (the sharded one resampled as the sharded
    blend does, from a haloed block with ``x_start``) lie closer to it than
    to each other. Each frame is also solved and blended on the group with
    no live halo (the witness), and held to ``fuse_frame`` by phase 16's
    rules (rtol 3e-4, atol 3e-6; its near voxels as phase 16 counts them).
    Returns (max|Δ|s, the largest near share, the witness's max|Δ|s and
    near share, the free runs' warp max|Δ| by frame, iterations, the flat
    run's frames/s)."""
    flat_warps = {}
    ref, flat_fps = _fps(ds.frames, ds.camera, pipeline_cfg)
    fusion.fuse_sequence(ds.frames, ds.camera, pipeline_cfg, device="cuda",
                         frame_callback=lambda t, s, w: flat_warps.__setitem__(t, w.clone()))
    its = [r.solver_iterations for r in got.reports]
    if its != [r.solver_iterations for r in ref.reports]:
        raise AssertionError(f"sharded fusion iterations {its} != "
                             f"{[r.solver_iterations for r in ref.reports]}")
    free = [float(torch.max(torch.abs(after[t][1] - flat_warps[t]))) for t in sorted(after)]
    device = torch.device("cuda")
    first = fusion._tsdf(ds.frames[0], ds.camera, pipeline_cfg, device)
    after[0] = (fusion.init_state(first), torch.zeros_like(after[1][1]))
    bound = float(np.float32(1.0 - fusion.TRUNCATION_EPS))
    errs = {"warp": 0.0, "canonical": 0.0, "weights": 0.0}
    witness, witness_near = dict(errs), 0.0
    near_max = 0.0
    for t in range(1, len(ds.frames)):
        state0, warp0 = after[t - 1]
        live = fusion._tsdf(ds.frames[t], ds.camera, pipeline_cfg, device)
        state, warp, report, _ = fusion.fuse_frame(state0, live, warp0, pipeline_cfg.solver,
                                                   pipeline_cfg, t)
        if report.solver_iterations != its[t - 1]:
            raise AssertionError(f"frame {t}: {report.solver_iterations} iterations, sharded "
                                 f"{its[t - 1]}")
        sh_state, sh_warp = after[t]
        errs["warp"] = max(errs["warp"], _close(f"frame {t} warp", sh_warp, warp, 1e-4, 2e-5))
        halo = fusion.blend_halo(got.reports[t - 1].max_abs_displacement[0], live_halo)
        w_sh = warp_field_sharded(live, sh_warp, group, halo)
        w_flat = warp_field_cm(live, to_component_major(warp))
        near = torch.abs(torch.abs(w_flat) - bound) <= torch.abs(w_sh - w_flat)
        near_max = max(near_max, float(near.float().mean()))
        if near_max > 0.01:
            raise AssertionError(f"frame {t}: {near_max:.2%} of the voxels lie near the bound")
        far = ~near
        errs["canonical"] = max(errs["canonical"], _close(
            f"frame {t} canonical", sh_state.canonical[far], state.canonical[far], 1e-4, 2e-5))
        errs["weights"] = max(errs["weights"], _close(
            f"frame {t} weights", sh_state.weights[far], state.weights[far], 0.0, 0.0))
        # The witness: the same frame on the group with no live halo, so that
        # B1 samples at float(i) + u as the flat path does (x_start 0), in
        # the solve and the blend, held to phase 16's rules.
        res0 = solve_single_level_sharded(state0.canonical, live, pipeline_cfg.solver,
                                          group=group, live_halo=0, initial_warp=warp0)
        w0 = warp_field_sharded(live, res0.warp, group, 0)
        state_w = fusion.blend(state0, w0)
        if res0.iterations != its[t - 1]:
            raise AssertionError(f"witness frame {t}: {res0.iterations} iterations, sharded "
                                 f"{its[t - 1]}")
        witness["warp"] = max(witness["warp"], _close(
            f"witness frame {t} warp", res0.warp, warp, 3e-4, 3e-6))
        near0 = torch.abs(torch.abs(w_flat) - bound) <= float(torch.max(torch.abs(w0 - w_flat)))
        witness_near = max(witness_near, float(near0.float().mean()))
        if witness_near > 0.01:
            raise AssertionError(f"witness frame {t}: {witness_near:.2%} near the bound")
        far0 = ~near0
        witness["canonical"] = max(witness["canonical"], _close(
            f"witness frame {t} canonical", state_w.canonical[far0], state.canonical[far0],
            3e-4, 3e-6))
        witness["weights"] = max(witness["weights"], _close(
            f"witness frame {t} weights", state_w.weights[far0], state.weights[far0], 0.0, 0.0))
    return errs, near_max, witness, witness_near, free, its, flat_fps


C5_2D, C5_SCHUR, C5_SCHUR2D, C5_HIER = ("config5_2dmesh", "config5_sharded_schur",
                                        "config5_schur2d", "config5_hierarchical")
# Phase 25's splits of B2's y window: (label, the preset whose terms and halos
# the calls take, the volume, the mesh). config5_2dmesh's (2, 4) split of
# (128, 64, 128) (blocks (64, 16, 128)) under its own Tikhonov energy and
# under config5_512's Killing + level set + Sobolev, and config5_512's 512³
# on a (2, 4) mesh (blocks (256, 128, 512)). Every block keeps stencil_halo
# slices a side along both axes, garbage beyond the volume.
WINDOW_2D_SPLITS = (
    (f"{C5_2D} {tuple(PRESETS[C5_2D].grid_shape)} / (2, 4)", C5_2D,
     PRESETS[C5_2D].grid_shape, (2, 4)),
    (f"{C5_2D} {tuple(PRESETS[C5_2D].grid_shape)} / (2, 4), {C5_512}'s terms", C5_512,
     PRESETS[C5_2D].grid_shape, (2, 4)),
    (f"{C5_512} {C5_512_SHAPE} / (2, 4)", C5_512, C5_512_SHAPE, (2, 4)),
)
CONV_LOCAL_SPLIT = (C5_512, C5_512_SHAPE, 8)  # conv_local_x on 512³ / 8, 2 ghost rows


def _haloed_2d(ext, i0, n0, i1, n1, h0, h1, axis=0):
    """Block (i0, i1) of a field padded by ``h0`` rows and ``h1`` columns a
    side (``ext``), with that halo."""
    return ext.narrow(axis, i0 * n0, n0 + 2 * h0).narrow(axis + 1, i1 * n1,
                                                            n1 + 2 * h1).contiguous()


def _pad_2d(a, h0, h1, fill):
    """``a`` (X, Y, Z) or (3, X, Y, Z) padded by ``h0`` rows and ``h1``
    columns a side with ``fill``."""
    return F.pad(a[None], [0, 0, h1, h1, h0, h0], value=fill)[0]


def _time_b2(blocks, rate, kw, win):
    """B2 on a window, timed in turns with its plain version: (the kernel's
    best ms of two runs of 20 calls, the plain version's ms of 3, the
    function's bound)."""
    call = lambda: fused_gradient_update(*blocks, rate, **kw, **win)  # noqa: E731
    runs = [_time_ms(call, 20)]
    plain = _time_ms(lambda: fused_gradient_update_reference(*blocks, rate, **kw, **win), 3)
    runs.append(_time_ms(call, 20))
    out_vox = win["x_len"] * win.get("y_len", blocks[0].shape[1]) * blocks[0].shape[2]
    bound = _bound(4 * (5 * blocks[0].numel() + 3 * out_vox), OPS_FUSED * out_vox)
    return min(runs), runs, plain, bound


def phase25_windows_2d():
    """B2's y window on every block of ``WINDOW_2D_SPLITS`` and
    ``conv_local_x`` on every rank of config5_512's 512³ / 8 (the Schur
    presets run no Sobolev filter, so they cannot show it), each held to
    its plain version (the warp within 4.8e-7, the sums within rel 1e-4,
    the maxes rel 1e-5). The y windows' union equals the whole-volume call
    (the warp within 4.8e-7, the summed energies and sum|δu| within rel
    1e-5, the maxes exactly). conv_local_x's does not: its x pass stops at
    each block's rows, so only the rows at least R from a block face equal
    the whole call's (within 4.8e-7), and those are held. Then one windowed
    B2 call at the 512³ 2D shard and one under conv_local_x at the 512³ / 8
    shard, timed beside their plain versions, with their bounds. Returns the
    worst max|Δ|s, those of each split, and the two shards' numbers."""
    rate = torch.tensor(0.3, device="cuda")
    worst = {"fused": 0.0, "union": 0.0}
    by_split, timing = {}, {}
    for seed, (label, preset, shape, mesh) in enumerate(WINDOW_2D_SPLITS, 60):
        p = PRESETS[preset]
        h, kw = p.solver.stencil_halo, single_level.fused_step_kwargs(p.solver)
        canonical, warped, warp = _device_fields(shape, seed, 0.8)
        whole_w, whole_s = fused_gradient_update(warped, canonical, warp, rate, **kw)
        exts = [_pad_2d(a, h, h, WINDOW_GHOST) for a in (warped, canonical, warp)]
        del canonical, warped, warp
        n0, n1 = shape[0] // mesh[0], shape[1] // mesh[1]
        sums = torch.zeros(4, dtype=torch.float64, device="cuda")
        maxes = torch.zeros(4, device="cuda")
        errs = {"fused": 0.0, "union": 0.0}
        for i0 in range(mesh[0]):
            for i1 in range(mesh[1]):
                blocks = [_haloed_2d(e, i0, n0, i1, n1, h, h, axis) for e, axis in
                          zip(exts, (0, 0, 1))]
                win = dict(x_offset=i0 * n0 - h, x_global=shape[0], x_lo=h, x_len=n0,
                           y_offset=i1 * n1 - h, y_global=shape[1], y_lo=h, y_len=n1)
                got = fused_gradient_update(*blocks, rate, **kw, **win)
                torch.cuda.synchronize()
                want = fused_gradient_update_reference(*blocks, rate, **kw, **win)
                name = f"y window {label} block ({i0}, {i1})"
                errs["fused"] = max(errs["fused"], _check_fused(name, got, want, rtol=0.0,
                                                                atol=4.8e-7))
                del want
                errs["union"] = max(errs["union"], _close(
                    f"{name} vs the whole call", got[0],
                    whole_w[:, i0 * n0:(i0 + 1) * n0, i1 * n1:(i1 + 1) * n1], 0.0, 4.8e-7))
                sums += got[1][:4].double()
                maxes = torch.maximum(maxes, got[1][4:])
                if shape == C5_512_SHAPE and (i0, i1) == (0, 1):
                    timing["y_window"] = _time_b2(blocks, rate, kw, win) + (
                        tuple(blocks[0].shape), (n0, n1))
                del got, blocks
        _close(f"y window {label}: summed energies and sum|du|", sums[:4],
               whole_s[:4].double(), 1e-5)
        _close(f"y window {label}: maxes", maxes, whole_s[4:], 0.0)
        by_split[label] = errs
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        del exts, whole_w
        torch.cuda.empty_cache()
    # conv_local_x: the Schur solvers' block-local filter on 512³ / 8.
    preset, shape, world = CONV_LOCAL_SPLIT
    kw = single_level.fused_step_kwargs(PRESETS[preset].solver)
    radius = len(kw["taps"]) // 2
    canonical, warped, warp = _device_fields(shape, 70, 0.8)
    whole_w, _ = fused_gradient_update(warped, canonical, warp, rate, **kw)
    nl = shape[0] // world
    errs = {"fused": 0.0, "interior": 0.0}
    for rank in range(world):
        blocks = [_haloed(a, rank, nl, 2, WINDOW_GHOST, axis)
                  for a, axis in ((warped, 0), (canonical, 0), (warp, 1))]
        win = dict(x_offset=rank * nl - 2, x_global=shape[0], x_lo=2, x_len=nl,
                   conv_local_x=True)
        got = fused_gradient_update(*blocks, rate, **kw, **win)
        torch.cuda.synchronize()
        want = fused_gradient_update_reference(*blocks, rate, **kw, **win)
        name = f"conv_local_x {shape} rank {rank}"
        errs["fused"] = max(errs["fused"], _check_fused(name, got, want, rtol=0.0,
                                                        atol=4.8e-7))
        errs["interior"] = max(errs["interior"], _close(
            f"{name}: rows at least {radius} from a block face vs the whole call",
            got[0][:, radius:nl - radius],
            whole_w[:, rank * nl + radius:(rank + 1) * nl - radius], 0.0, 4.8e-7))
        if rank == 1:
            timing["conv_local_x"] = _time_b2(blocks, rate, kw, win) + (
                tuple(blocks[0].shape), (nl, shape[1]))
        del got, want, blocks
    label = _split_name(preset, shape, world) + " conv_local_x"
    by_split[label] = errs
    worst["fused"] = max(worst["fused"], errs["fused"])
    del canonical, warped, warp, whole_w
    torch.cuda.empty_cache()
    shards = {}
    for key, (ms, runs, plain, bound, in_shape, out_2d) in timing.items():
        shards[key] = (ms, plain, bound, in_shape)
        print(f"[25] B2 {key} at the shard {in_shape} -> window {out_2d}: "
              f"{[round(t * 1e3, 1) for t in runs]} us (plain {plain * 1e3:.1f} us, bound "
              f"{bound[0] * 1e3:.1f} us by {bound[1]})")
    print(f"[25] B2's y window on every block of {[s[0] for s in WINDOW_2D_SPLITS]} vs plain "
          f"warp max|Δ| {worst['fused']:.3e} (atol 4.8e-7), the union vs the whole call "
          f"{worst['union']:.3e}; conv_local_x on every rank of {_split_name(*CONV_LOCAL_SPLIT)} "
          f"vs plain {errs['fused']:.3e}, rows at least {radius} from a block face vs the "
          f"whole call {errs['interior']:.3e} (the rows nearer differ: the x pass stops at "
          f"the block); by split {by_split}")
    return worst, by_split, shards


class _Sharded2DLoop:
    """The 2D-mesh solve on a mesh as a loop object, for ``_solve_ms`` and
    ``_profile_solve``."""

    def __init__(self, params, mesh, live_halo):
        self.params, self.mesh, self.live_halo = params, mesh, live_halo

    def solve(self, canonical, live):
        return solve_single_level_sharded2d(canonical, live, self.params, mesh=self.mesh,
                                            live_halo=self.live_halo)


def _one_rank(cfg):
    """``cfg`` on a world of 1: a ``mesh_shape`` (1, 1) where it has one."""
    return dataclasses.replace(cfg, mesh_shape=(1, 1)) if cfg.mesh_shape else cfg


def _mesh_multi(runs):
    """The new solvers on 2 and 4 NCCL ranks, each against its one-rank run
    (``runs``: a preset's name to that run's summary), as many as the
    process's devices allow."""
    n = torch.cuda.device_count()
    if n < 2:
        return [f"the multi-rank runs need a second device: this process sees {n}"]
    lines = []
    for world, mesh in ((2, (1, 2)), (4, (2, 2))):
        if world > n:
            break
        for name, equal in ((C5_2D, True), (C5_SCHUR2D, False), (C5_SCHUR, False),
                            (C5_HIER, True)):
            cfg = PRESETS[name]
            cfg = dataclasses.replace(cfg, mesh_shape=mesh) if cfg.mesh_shape else cfg
            lines.append(_ranks(cfg, runs[name], world, equal))
    return lines


def _hierarchical_held(hier, ref, canonical, live, hp, group):
    """The hierarchical sharded solve on a world of 1 against the
    single-device one (``ref``), as phase 24 holds the sharded fusion: its
    sharded levels sample at float(x_start + i) + u, the single-device
    levels at float(i) + u, and a warped value that this rounding moves
    across the band's bound switches the data term there for the rest of a
    level's ~100 iterations, with this preset's 10-voxel motion. So the warp
    within atol 5e-5 rtol 1e-4 on all but at most 1% of the voxels; and the
    witness, each level solved as ``hier`` solved it but its sharded levels
    with no live halo (x_start 0), held to phase 16's rules (rtol 3e-4,
    atol 3e-6). Returns (max|Δ|, the share beyond the tolerance, the
    witness's max|Δ|)."""
    diff = torch.abs(hier.warp - ref.warp)
    share = float((diff > 5e-5 + 1e-4 * torch.abs(ref.warp)).float().mean())
    if share > 0.01:
        raise AssertionError(f"{C5_HIER}: {share:.3%} of the warp beyond atol 5e-5 rtol 1e-4")
    canon_pyr = pyramid.build_pyramid(canonical, hp.levels)
    live_pyr = pyramid.build_pyramid(live, hp.levels)
    warp = None
    for level, halo in enumerate(hier.level_halos):
        c, l = canon_pyr[level], live_pyr[level]
        res = (solve_single_level(c, l, hp.base, initial_warp=warp) if halo is None else
               solve_single_level_sharded(c, l, hp.base, group=group, live_halo=0,
                                          initial_warp=warp))
        warp = (pyramid.prolongate_warp(res.warp, target_shape=canon_pyr[level + 1].shape)
                if level + 1 < hp.levels else res.warp)
    witness = _close(f"{C5_HIER} witness (no live halo) vs the single-device port", warp,
                     ref.warp, 3e-4, 3e-6)
    return float(torch.max(diff)), share, witness


def phase26_mesh_solvers(sharded_1d):
    """The slice's solvers through ``cli.run_experiment`` on a world of 1
    (NCCL), the launch counters reset just before each run: config5_2dmesh
    and config5_schur2d on a (1, 1) mesh, config5_sharded_schur and
    config5_hierarchical; each converges or reduces the residual, with no
    contract violation. Held to the single-device port on the card: the 2D
    sync solve's iterations and warp (atol 2e-5 rtol 1e-4, the JAX parity
    test's); the Schur solvers', whose one block has no cut, to
    ``solve_single_level`` run for their outer steps x T iterations (the
    presets' rate is fixed); the hierarchical solve's per-level iterations
    and warp to ``solve_hierarchical``. Then
    config5_512's problem through ``solve_single_level_sharded2d`` on a
    (1, 1) mesh: µs/iter, voxel·iter/s and peak memory beside phase 23's 1D
    numbers (``sharded_1d``), and a profiler breakdown of 8 iterations.
    With more devices, the solvers on 2 and 4 NCCL ranks. The hierarchical
    solve is held by ``_hierarchical_held``'s rules."""
    paths, runs, errs = {}, {}, {}
    for name in (C5_2D, C5_SCHUR, C5_SCHUR2D, C5_HIER):
        cfg = _one_rank(PRESETS[name])
        _reset_launches()
        summary, wall = _cli_run(cfg, "cuda")
        paths[name] = _read_launches()
        numbers = [summary[k] for k in ("residual_before", "residual_after")]
        if (not all(np.isfinite(numbers + summary["max_abs_displacement"]))
                or summary["residual_after"] >= summary["residual_before"]
                or summary["contract_violations"]):
            raise AssertionError(f"{name}: {summary}")
        if "outer_steps" in summary:
            inner = summary["total_inner_iterations"]
            want = {"resample": inner + 1, "fused_gradient": inner, "loop_tail": 0}
        elif "iterations_per_level" in summary:
            want = None
        else:
            want = _sharded_launches(summary["iterations"])
        if want is not None and paths[name] != want:
            raise AssertionError(f"{name}: launches {paths[name]}, want {want}")
        if min(paths[name]["resample"], paths[name]["fused_gradient"]) == 0:
            raise AssertionError(f"{name}: a kernel never launched: {paths[name]}")
        runs[name] = summary
        runs[name]["wall"] = wall
    group = init_group("cuda")
    try:
        mesh = make_mesh_2d(group, (1, 1))
        cfg = PRESETS[C5_2D]
        canonical, live = _pair_3d(cfg, _grid(cfg), group.device)
        sh = solve_single_level_sharded2d(canonical, live, cfg.solver, mesh=mesh,
                                          live_halo=cfg.live_halo)
        single = solve_single_level(canonical, live, cfg.solver)
        if not sh.iterations == single.iterations == runs[C5_2D]["iterations"]:
            raise AssertionError(f"{C5_2D}: 2D {sh.iterations}, single-device "
                                 f"{single.iterations}, CLI {runs[C5_2D]['iterations']}")
        errs[C5_2D] = _close(f"{C5_2D} warp vs the single-device port", sh.warp, single.warp,
                             1e-4, 2e-5)
        for name in (C5_SCHUR, C5_SCHUR2D):
            cfg = PRESETS[name]
            steps, t = runs[name]["outer_steps"], cfg.schur_inner_iterations
            kw = dict(live_halo=cfg.live_halo, inner_iterations=t)
            res = (solve_single_level_schur(canonical, live, cfg.solver, group=group, **kw)
                   if name == C5_SCHUR else
                   solve_single_level_schur2d(canonical, live, cfg.solver, mesh=mesh, **kw))
            plain = solve_single_level(canonical, live, cfg.solver.replace(
                max_iterations=steps * t, convergence_threshold=0.0))
            if res.outer_steps != steps or plain.iterations != steps * t:
                raise AssertionError(f"{name}: {res.outer_steps} outer steps (CLI {steps}), "
                                     f"the single-device solve {plain.iterations}")
            errs[name] = _close(f"{name} warp vs the single-device port", res.warp,
                                plain.warp, 1e-4, 2e-5)
        cfg = PRESETS[C5_HIER]
        hc, hl = _pair_3d(cfg, _grid(cfg), group.device)
        hp = HierarchicalParams(levels=cfg.levels, base=cfg.solver)
        hier = solve_hierarchical_sharded(hc, hl, hp, group=group, min_live_halo=cfg.live_halo)
        ref = solve_hierarchical(hc, hl, hp)
        its = [r.iterations for r in hier.level_results]
        if its != [r.iterations for r in ref.level_results] or its != runs[C5_HIER][
                "iterations_per_level"]:
            raise AssertionError(f"{C5_HIER}: {its}, single-device "
                                 f"{[r.iterations for r in ref.level_results]}, CLI "
                                 f"{runs[C5_HIER]['iterations_per_level']}")
        errs[C5_HIER] = _hierarchical_held(hier, ref, hc, hl, hp, group)
        del canonical, live, hc, hl, sh, single, hier, ref
        cfg = PRESETS[C5_512]
        canonical, live = _pair_3d(cfg, _grid(cfg), group.device)
        loop = _Sharded2DLoop(cfg.solver, mesh, cfg.live_halo)
        res = loop.solve(canonical, live)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = [_solve_ms(loop, canonical, live) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_iter_ms = min(timed) / res.iterations
        rate = canonical.numel() / (per_iter_ms / 1e3)
        short = _Sharded2DLoop(cfg.solver.replace(max_iterations=8, convergence_threshold=0.0),
                               mesh, cfg.live_halo)
        profile = _profile_solve(short, canonical, live, per_iter_ms * 1e3, "eager 2D sharded",
                                 where=f"{C5_512} solve at {C5_512_SHAPE}, (1, 1) mesh")
        del canonical, live
    finally:
        close_group(group)
    torch.cuda.empty_cache()
    hier_err, hier_share, witness = errs.pop(C5_HIER)
    errs[C5_HIER] = hier_err
    for name in (C5_2D, C5_SCHUR, C5_SCHUR2D, C5_HIER):
        r = runs[name]
        steps = (f"{r['outer_steps']} outer steps x {r['inner_per_outer']}"
                 if "outer_steps" in r else _steps(r))
        print(f"[26] {name} on a world of 1 (NCCL) through cli.run_experiment: {steps} "
              f"iterations, converged {r['converged']}, residual {r['residual_before']:.6g} -> "
              f"{r['residual_after']:.6g}, wall {r['wall']:.2f} s, launches {paths[name]}; "
              f"warp vs the single-device port max|Δ| {errs[name]:.3e}")
    print(f"[26] {C5_HIER}: {hier_share:.4%} of the warp beyond atol 5e-5 rtol 1e-4 (at most "
          f"1%: B1's x_start rounding at the band's bound); level halos "
          f"{runs[C5_HIER]['level_live_halos']}; the witness with no live halo max|Δ| "
          f"{witness:.3e} (rtol 3e-4 atol 3e-6)")
    print(f"[26] {C5_512} {C5_512_SHAPE} through solve_single_level_sharded2d on a (1, 1) "
          f"mesh: {res.iterations} iterations in {min(timed):.1f} ms (runs "
          f"{[round(r, 2) for r in timed]}), {per_iter_ms * 1e3:.1f} us/iter, {rate:.4e} "
          f"voxel*iter/s, peak memory {peak:.2f} GiB; the 1D solver (phase 23): "
          f"{sharded_1d['config5_512_us_per_iter']:.1f} us/iter, "
          f"{sharded_1d['voxel_iter_per_s']:.4e} voxel*iter/s, {sharded_1d['peak_gib']:.2f} GiB")
    print(f"[26] {profile}")
    for line in _mesh_multi(runs):
        print(f"[26] {line}")
    return paths


def _fusion_held(label, got, ref, its):
    """A sharded fusion's final state against the single-device fusion's:
    the per-frame iterations equal; the canonical within atol 2e-5 rtol
    1e-4 (tests/test_fusion_sharded.py's) and the weights equal on all but
    at most 1% of the voxels (those whose blend value a resample's rounding
    moved across the band's bound, phase 24); the max|Δ| over the others."""
    want_its = [r.solver_iterations for r in ref.reports]
    if its != want_its:
        raise AssertionError(f"{label}: iterations {its} != {want_its}")
    a, b = got.state, ref.state
    off = (torch.abs(a.canonical - b.canonical) > 2e-5 + 1e-4 * torch.abs(b.canonical)) | (
        a.weights != b.weights)
    share = float(off.float().mean())
    if share > 0.01:
        raise AssertionError(f"{label}: {share:.2%} of the voxels differ")
    keep = ~off
    err = float(torch.max(torch.abs(a.canonical - b.canonical)[keep]))
    return share, err


def phase27_mesh_fusion():
    """``fuse_sequence_sharded`` on a world of 1 (NCCL) with config4's 128³
    x 8 sequence, the launch counters reset just before each run: with
    ``hierarchical=True`` (3 levels: coarse levels replicated, the finest
    sharded) against the hierarchical ``fuse_sequence``, and on a (1, 1)
    mesh against the flat ``fuse_sequence``, by ``_fusion_held``'s rules;
    frames/s of each beside the single-device path's."""
    cfg = PRESETS[C4]
    ds = cli._sequence_dataset(cfg)
    paths, lines = {}, []
    group = init_group("cuda")
    try:
        for label, hierarchical, mesh in (
                ("fusion_sharded_hierarchical", True, group),
                ("fusion_sharded_2d", False, make_mesh_2d(group, (1, 1)))):
            pipeline_cfg = fusion.FusionPipelineConfig(
                grid=_grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
                hierarchical=hierarchical, solver=cfg.solver)
            stamps = []
            _reset_launches()
            got = fusion.fuse_sequence_sharded(
                ds.frames, ds.camera, pipeline_cfg, group=mesh,
                mesh_axes=None if hierarchical else ("x", "y"), live_halo=cfg.live_halo,
                frame_callback=lambda t, s, w: stamps.append(time.perf_counter()))
            paths[label] = _read_launches()
            fps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            its = [r.solver_iterations for r in got.reports]
            if any(r.contract_violations for r in got.reports) or min(
                    paths[label]["resample"], paths[label]["fused_gradient"]) == 0:
                raise AssertionError(f"{label}: {paths[label]} "
                                     f"{[r.contract_violations for r in got.reports]}")
            if not hierarchical and paths[label] != {"resample": sum(its) + len(its),
                                                     "loop_tail": 0,
                                                     "fused_gradient": sum(its)}:
                raise AssertionError(f"{label}: launches {paths[label]} for {its}")
            ref, ref_fps = _fps(ds.frames, ds.camera, pipeline_cfg)
            share, err = _fusion_held(label, got, ref, its)
            lines.append(f"{label}: iterations {its}, as fuse_sequence's; the final "
                         f"canonical max|Δ| {err:.3e} (atol 2e-5 rtol 1e-4) away from "
                         f"{share:.3%} of the voxels; launches {paths[label]}; {fps:.2f} "
                         f"frames/s (fuse_sequence {ref_fps:.2f})")
    finally:
        close_group(group)
    for line in lines:
        print(f"[27] {C4} at {cfg.grid_shape} x {len(ds.frames)} frames on a world of 1 "
              f"(NCCL): {line}")
    return paths


def _write_depth_directory(root, ds):
    """``ds``'s frames as 16-bit depth PNGs (the port's writer) and its
    camera as ``intrinsics.json`` in ``root``: a ``depth_directory``."""
    for t, frame in enumerate(ds.frames):
        depth.save_depth_png(os.path.join(root, f"depth_{t:06d}.png"), frame)
    cam = ds.camera
    with open(os.path.join(root, "intrinsics.json"), "w") as f:
        json.dump({"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                   "width": cam.image_width, "height": cam.image_height}, f)


def phase28_config4_disk():
    """config4 read from disk (A9): its 8 frames written as 16-bit PNGs with
    ``intrinsics.json`` by the port's writer, then ``multi_frame_3d`` from
    that ``depth_directory`` at 128³ through ``cli.run_experiment`` with the
    launch counters reset. The frames come through the native prefetcher
    (pinned tensors, copied ``non_blocking``) where the decoder was built,
    and the phase fails if it was expected and did not load. The run must
    equal ``fuse_sequence`` of the decoded frames held in memory exactly
    (reports, state, warp), launch B1 and B2 as phase 17 does, and a run
    stopped after frame C4_STOP's checkpoint and resumed from the same
    directory must end in its state. Then ``fuse_sequence`` alone from four
    frame sources in turns, 3 rounds (in memory, from disk, the prefetched
    pinned frames held in memory, decoded on the main thread), frames/s
    beside each other, and the device's busy share over a fusion from disk
    (the profiler's device events against the same fusion unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = PRESETS[C4]
    mem_ds = cli._sequence_dataset(cfg)
    decoder = "native" if native_loader.native_available() else "plain"
    pipeline_cfg = fusion.FusionPipelineConfig(
        grid=_grid(cfg), narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        hierarchical=False, solver=cfg.solver)
    with tempfile.TemporaryDirectory() as root:
        seq_dir = os.path.join(root, "seq")
        os.makedirs(seq_dir)
        _write_depth_directory(seq_dir, mem_ds)
        disk_cfg = dataclasses.replace(cfg, dataset="depth_directory",
                                       dataset_kwargs={"path": seq_dir})
        ds = datasets.get("depth_directory", path=seq_dir)
        decoded = [depth.load_depth_png(p, decoder="plain") for p in ds._paths]
        quant = max(float(np.max(np.abs(a - b))) for a, b in zip(decoded, mem_ds.frames))
        source = ds.frame_source()
        source_kind = type(source).__name__
        if decoder == "native" and not isinstance(source, native_loader.DepthPrefetcher):
            raise AssertionError(f"the native decoder is built but the source is {source_kind}")
        frames = list(source)
        pinned = all(f.is_pinned() for f in frames)
        if decoder == "native" and not pinned:
            raise AssertionError("the prefetcher's frames are not in pinned memory")
        for got, want in zip(frames, decoded):
            if not np.array_equal(np.asarray(got), want):
                raise AssertionError(f"the {decoder} decoder differs from the plain one")
        out, stopped = os.path.join(root, "c4disk"), os.path.join(root, "stopped")
        release_kept_loops()  # the counts below take a new loop's warm-up and capture
        _reset_launches()
        t0 = time.perf_counter()
        summary = run_experiment(disk_cfg, out, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        final = len(ds) - 1
        state, warp, _ = checkpoint.load(os.path.join(out, "checkpoints"), final, "cuda")
        save, save_then_stop = _stop_after(C4_STOP)
        checkpoint.save = save_then_stop
        try:
            run_experiment(disk_cfg, stopped, device="cuda")
            raise AssertionError("the stopped run did not stop")
        except _Stop:
            pass
        finally:
            checkpoint.save = save
        resumed = run_experiment(disk_cfg, stopped, device="cuda", resume=True)
        got_state, got_warp, _ = checkpoint.load(os.path.join(stopped, "checkpoints"), final,
                                                 "cuda")
        mem = fusion.fuse_sequence(decoded, ds.camera, pipeline_cfg, device="cuda")
        # Frame sources in turns, 3 rounds: in memory (numpy), from disk
        # (the prefetcher), the prefetched pinned tensors held in memory (the
        # copy alone), and decoded on the main thread (_LazyFrames).
        sources = {"memory": lambda: decoded, "disk": ds.frame_source,
                   "pinned_in_memory": lambda: frames,
                   "main_thread_decode": lambda: datasets._LazyFrames(ds._paths)}
        fps = {name: [] for name in sources}
        names = list(sources)
        for r in range(3):
            for name in names[r:] + names[:r]:
                fps[name].append(_fps(sources[name](), ds.camera, pipeline_cfg)[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fusion.fuse_sequence(ds.frame_source(), ds.camera, pipeline_cfg, device="cuda")
        torch.cuda.synchronize()
        plain_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fusion.fuse_sequence(ds.frame_source(), ds.camera, pipeline_cfg, device="cuda")
            torch.cuda.synchronize()
            profiled_us = (time.perf_counter() - t0) * 1e6
        busy_us, _ = _device_busy_us(prof)
    reports = summary["reports"]
    its = [r["solver_iterations"] for r in reports]
    want = {"resample": _chunk_launches(its) + len(reports),
            "fused_gradient": _chunk_launches(its), "loop_tail": _chunk_launches(its)}
    if json.loads(json.dumps(reports)) != json.loads(json.dumps(
            [r._asdict() for r in mem.reports])):
        raise AssertionError(f"from disk {reports} != in memory {mem.reports}")
    for a, b in zip((*state, warp), (*mem.state, mem.final_warp)):
        if not torch.equal(a, b):
            raise AssertionError("the fusion from disk differs from the in-memory fusion")
    for a, b in zip((*got_state, got_warp), (*state, warp)):
        if not torch.equal(a, b):
            raise AssertionError("the resumed run's final state differs from the uninterrupted run's")
    if [r["frame_index"] for r in resumed["reports"]] != list(range(C4_STOP + 1, final + 1)):
        raise AssertionError(f"resumed reports {resumed['reports']}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} for iterations {its}, want {want}")
    if quant > 0.0005 + 1e-6:
        raise AssertionError(f"decoded frames {quant} m from the written ones (> 0.5 mm)")
    if not np.isfinite([summary["frames_per_s"], *(v for f in fps.values() for v in f)]).all():
        raise AssertionError(f"non-finite frames/s {summary['frames_per_s']} {fps}")
    turns = "; ".join(f"{name} {np.median(f):.2f} ({', '.join(f'{v:.2f}' for v in f)})"
                      for name, f in fps.items())
    busy = (f"{busy_us / 1e3:.1f} ms, {busy_us / plain_us:.1%} of the {plain_us / 1e3:.1f} ms "
            f"the same fusion takes unprofiled (idle {1 - busy_us / plain_us:.1%}; "
            f"{busy_us / profiled_us:.1%} of the profiled {profiled_us / 1e3:.1f} ms)"
            if busy_us else "not measured (no device events)")
    print(f"[28] {C4} from a depth_directory of {len(ds)} PNGs "
          f"({ds.camera.image_width}x{ds.camera.image_height}, max |decoded - written| "
          f"{quant * 1e3:.3f} mm) at {cfg.grid_shape} on cuda through cli.run_experiment: "
          f"decoder {decoder} ({source_kind}, pinned frames {pinned}); "
          f"iterations {its}; equal to the in-memory fusion of the decoded frames (reports, "
          f"state, warp); launches {launches}; CLI frames_per_s {summary['frames_per_s']} "
          f"(checkpoints every {cfg.checkpoint_every} frames inside), wall {wall:.2f} s; "
          f"fuse_sequence alone, frames/s by source in turns, median (runs): {turns}; "
          f"profiler over a fusion from disk (8 frames, the "
          f"first's TSDF included): device busy {busy}; resumed after frame "
          f"{C4_STOP}: frames {[r['frame_index'] for r in resumed['reports']]}, final state "
          "equal")
    return launches


def phase29_dryrun():
    """``dryrun.dryrun_multichip`` (A12b) on a world of 1 (NCCL) with the
    launch counters reset, B1 and B2 launched; on 2 NCCL ranks (torchrun's
    environment, one device each) where the process sees two devices."""
    group = init_group("cuda")
    try:
        _reset_launches()
        line = dryrun.dryrun_multichip(group)
        launches = _read_launches()
    finally:
        close_group(group)
    if not (launches["resample"] and launches["fused_gradient"]):
        raise AssertionError(f"the dry run launched {launches}")
    print(f"[29] {line}; launches {launches}")
    if torch.cuda.device_count() < 2:
        print("[29] 2 NCCL ranks: not exercised (the process sees one device)")
        return launches
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "levelsetfusion_tpu_torch.dryrun"],
        env={**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError(f"the 2-rank dry run failed: {[e[-2000:] for _, e in outs]}")
    print(f"[29] 2 NCCL ranks: {outs[0][0].strip()}")
    return launches


def phase30_utilities():
    """A10b on the card: config1 through ``cli.main`` with ``--verbose``,
    ``--profile`` and ``--check-nans`` (a focus_voxel event, a trace with
    device events, the iterations and residuals of the run without the
    flags; the plots or their artifacts_skipped event); ``validate_solve``
    and ``nan_checks`` on a diverging rate, naming the CPU solve's iteration;
    ``advect_field`` on the card against the CPU."""
    cfg = PRESETS[C1]
    with tempfile.TemporaryDirectory() as root:
        plain_out, flagged = os.path.join(root, "plain"), os.path.join(root, "flagged")
        plain = run_experiment(cfg, plain_out, device="cuda")
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
                contextlib.redirect_stderr(null):  # the summary and --verbose's echo
            rc = cli.main(["--preset", C1, "--out", flagged, "--verbose", "--profile",
                           "--check-nans"])
        with open(os.path.join(flagged, "summary.json")) as f:
            checked = json.load(f)
        with open(os.path.join(flagged, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        trace_path = os.path.join(flagged, "trace", "trace.json")
        with open(trace_path) as f:
            trace_events = json.load(f)["traceEvents"]
        trace_mb = os.path.getsize(trace_path) / 2**20
        pngs = sorted(f for f in os.listdir(flagged) if f.endswith(".png"))
    kernels = sum(e.get("cat") == "kernel" for e in trace_events)
    focus = [e for e in events if e["event"] == "focus_voxel"]
    skipped = [e for e in events if e["event"] == "artifacts_skipped"]
    if rc != 0 or checked["iterations"] != plain["iterations"] or not checked["converged"]:
        raise AssertionError(f"--check-nans run {checked} against {plain}")
    for key in ("residual_before", "residual_after"):
        if checked[key] != plain[key]:
            raise AssertionError(f"--check-nans {key} {checked[key]} != {plain[key]}")
    if len(focus) != 1 or not kernels:
        raise AssertionError(f"focus events {focus}, {kernels} kernel events in the trace")
    if not pngs and not skipped:
        raise AssertionError("no plots and no artifacts_skipped event")
    rng = np.random.default_rng(30)
    base = rng.standard_normal((24, 20, 16)).astype(np.float32)
    pair = [torch.from_numpy(np.tanh(b * 0.3)) for b in (base, np.roll(base, 1, 0))]
    diverging = SolverParams(max_iterations=40, learning_rate=1e6, convergence_threshold=0.0)
    messages = {}
    for device in ("cpu", "cuda"):
        res = solve_single_level(*(t.to(device) for t in pair), diverging)
        try:
            validate_solve(res)
            raise AssertionError(f"validate_solve passed a diverging solve on {device}")
        except NonFiniteError as err:
            messages[device] = str(err)
    if messages["cuda"] != messages["cpu"]:
        raise AssertionError(f"validate_solve on the card: {messages}")
    try:
        with nan_checks():
            solve_single_level(*(t.cuda() for t in pair), diverging)
        raise AssertionError("nan_checks passed a diverging solve")
    except NonFiniteError as err:
        nan_message = str(err)
    field = torch.from_numpy(rng.uniform(-1, 1, (64, 64, 64)).astype(np.float32))
    warp = torch.from_numpy(rng.uniform(-2.5, 2.5, (64, 64, 64, 3)).astype(np.float32))
    advected = advect_field(field.cuda(), warp.cuda())
    torch.cuda.synchronize()
    advect_err = _close("advect_field", advected.cpu(), advect_field(field, warp), 0.0, 1e-5)
    print(f"[30] {C1} through cli.main with --verbose --profile --check-nans on cuda: "
          f"{checked['iterations']} iterations as without the flags (residual_after "
          f"{checked['residual_after']:.6g} equal), focus voxel {focus[0]['coords']}, trace "
          f"of {len(trace_events)} events ({kernels} kernels, {trace_mb:.1f} MB); plots "
          f"{pngs or 'skipped: ' + str(skipped[0]['missing']) + ' ' + str(skipped[0]['files'])}; "
          f"validate_solve on a diverging rate: {messages['cuda']!r} as on the cpu; "
          f"nan_checks: {nan_message!r}; advect_field at (64, 64, 64) against the cpu: "
          f"max|Δ| {advect_err:.2e} (atol 1e-5: scatter-adds in another order)")



def _row(name, source, replaces, numbers, per_iter=0):
    """A row of the ``kernels`` line; ``per_iter`` is the kernel's launches
    per config3 solve iteration."""
    return {"name": name, "route": "cuda",
            "source": f"levelsetfusion_tpu_torch/csrc/{source}", "replaces": replaces,
            **numbers, "main_path_launches_per_iter": per_iter}


def main():
    phase0_card()
    phase1_build()
    err_resample = phase2_resample()
    err_fused = phase3_fused()
    err_step2d, *times_step2d = phase3b_step2d()
    err_tail, *times_tail = phase3c_loop_tail()
    phase4_solve_parity()
    serial_it = phase4b_device_loop()
    main_launches = phase5_main_path(serial_it)
    times, grid_sample_ms = phase6_timing()
    phase7_ptxas()
    conv = phase8_mxu_conv()
    io = phase9_fused_io()
    dma = phase10_dma()
    phase11_b2_entry_points()
    variants = phase12_resample_variants()
    v10 = phase13_v10()
    bisect = phase14_bisect()
    loops = phase15_loop_cost()
    phase16_config4_parity()
    paths = {"config3": main_launches, "config4": phase17_config4(),
             "config1": phase18_config1(), "config2": phase19_config2()}
    phase20_rigid()
    paths["hierarchical_fusion"] = phase21_hierarchical_fusion()
    window_err, window_by_split, shard = phase22_windows()
    sharded_paths, sharded_1d = phase23_sharded()
    paths.update(sharded_paths)
    paths["fusion_sharded"] = phase24_sharded_fusion()
    window2d_err, window2d_by_split, shards2d = phase25_windows_2d()
    paths.update(phase26_mesh_solvers(sharded_1d))
    paths.update(phase27_mesh_fusion())
    paths["config4_disk"] = phase28_config4_disk()
    paths["dryrun"] = phase29_dryrun()
    phase30_utilities()
    by_path = {name: {path: c[name] for path, c in paths.items()}
               for name in ("resample", "fused_gradient")}
    ms, plain_ms, bound = times["resample"]
    resample_row = _numbers(sum(by_path["resample"].values()),
                            max(err_resample, window_err["resample"]), ms, plain_ms,
                            bound, grid_sample_ms)
    resample_row["launches_by_path"] = by_path["resample"]
    ms, plain_ms, bound = times["fused_gradient"]
    fused_row = _numbers(sum(by_path["fused_gradient"].values()),
                         max(err_fused, window_err["fused"], window2d_err["fused"]), ms,
                         plain_ms, bound, None)
    fused_row["launches_by_path"] = by_path["fused_gradient"]
    # The 2D step's launches: config1 and config2 (18, 19); the hierarchical
    # fusion (21) holds that a 3D path launches none.
    step2d_by_path = {path: c["step2d"] for path, c in paths.items() if "step2d" in c}
    step2d_row = _numbers(sum(step2d_by_path.values()), err_step2d, *times_step2d, None)
    step2d_row["launches_by_path"] = step2d_by_path
    step2d_row["main_path_launches_per_2d_iter"] = 1
    # The loop tail's launches: every path through a SolveLoop (5, 17-19,
    # 21, 28; the hierarchical sharded solvers' replicated levels), none on
    # the sharded solvers' own loops (23, 24, 26, 27).
    tail_by_path = {path: c["loop_tail"] for path, c in paths.items() if "loop_tail" in c}
    tail_row = _numbers(sum(tail_by_path.values()), err_tail, *times_tail, None)
    tail_row["launches_by_path"] = tail_by_path
    for row, name, err in ((resample_row, "resample", "resample"),
                           (fused_row, "fused_gradient", "fused")):
        w_ms, w_plain, w_bound, w_shape, w_lib = shard[name]
        row["windowed"] = {"shape": list(w_shape), "ms": w_ms, "plain_ms": w_plain,
                           "bound_ms": w_bound[0], "bound_by": w_bound[1], "library_ms": w_lib,
                           "max_abs_err_by_split": {
                               split: e[err] for split, e in window_by_split.items()}}
    # B2's y window and conv_local_x (phase 25), each at its 512³ shard.
    for key, (w_ms, w_plain, w_bound, w_shape) in shards2d.items():
        fused_row["windowed_" + key] = {
            "shape": list(w_shape), "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound[0],
            "bound_by": w_bound[1], "library_ms": None,
            "max_abs_err_by_split": {split: e["fused"] for split, e in window2d_by_split.items()
                                     if split.endswith("conv_local_x") == (
                                         key == "conv_local_x")}}
    kernels = [
        _row("warp_field_cm", "resample.cu",
             "levelsetfusion_tpu/ops/pallas/resample.py:427", resample_row, 1),
        _row("fused_gradient_update", "fused_gradient.cu",
             "levelsetfusion_tpu/ops/pallas/fused_gradient.py:1267", fused_row, 1),
        _row("step2d", "step2d.cu", None, step2d_row),
        _row("loop_tail", "loop_tail.cu", None, tail_row, 1),
        _row("conv_yz_stencil", "conv_yz.cu", "experiments/mxu_conv.py:117",
             conv["stencil"]),
        _row("conv_yz_banded_f32", "conv_yz.cu", "experiments/mxu_conv.py:122",
             conv["banded_f32"]),
        _row("conv_yz_banded_bf16", "conv_yz.cu", "experiments/mxu_conv.py:149",
             conv["banded_bf16"]),
        _row("fused_io_probe", "fused_io_probe.cu", "experiments/fused_io_probe.py:71",
             io["rolls"]),
        _row("fused_io_probe_copy", "fused_io_probe.cu", "experiments/fused_io_probe.py:71",
             io["copy"]),
        _row("dma_probe", "dma_probe.cu", "experiments/dma_probe.py:145", dma),
        _row("run_variant", "resample_variants.cu", "experiments/resample_variants.py:197",
             variants["run_variant"]),
        _row("run_vmemfull", "resample_variants.cu", "experiments/resample_variants.py:280",
             variants["run_vmemfull"]),
        _row("run_v7", "resample_variants.cu", "experiments/resample_variants.py:348",
             variants["run_v7"]),
        _row("run_v10", "v10_xslab.cu", "experiments/v10_xslab.py:88", v10),
        _row("bisect_v8", "stack_bodies.cu", "experiments/bisect_kernel.py:163",
             bisect["v8"]),
        _row("bisect_v8c", "stack_bodies.cu", "experiments/bisect_kernel.py:163",
             bisect["v8c"]),
        _row("bisect_level4", "stack_bodies.cu", "experiments/bisect_kernel.py:196",
             bisect["level4"]),
        _row("loop_cost_full_fori", "stack_bodies.cu", "experiments/loop_cost.py:79",
             loops["fori"]),
        _row("loop_cost_full_static", "stack_bodies.cu", "experiments/loop_cost.py:79",
             loops["static"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
