"""Frame-to-canonical fusion. Twin of ``levelsetfusion_tpu/models/fusion.py``,
its flat and hierarchical paths.

After the non-rigid solve aligns live frame t to the canonical frame, the
warped live TSDF is blended into the canonical field with
truncation-aware running weighted averaging:

    w_t(v)   = 1  where |Φ_w(v)| < 1 (inside the observed narrow band)
    Φ_c(v)  ←  (W(v) Φ_c(v) + w_t(v) Φ_w(v)) / (W(v) + w_t(v))
    W(v)    ←  W(v) + w_t(v)

A frame is one device program, as in JAX: TSDF generation, the solve
(``models/single_level.py``, its loop on the device; with ``hierarchical``
the coarse-to-fine solve of ``models/hierarchical.py`` over ``levels``
levels), the resample of the live field by the solved warp (B1), the blend,
and the frame's statistics packed into one small device tensor that the
host reads once. With ``warm_start`` (JAX's default) a frame's solve starts
from the previous frame's warp, else from zero. The flat path's
``fuse_sequence`` pipelines frames: frame t + 1 is dispatched from frame
t's device outputs before frame t's statistics are read; the hierarchical
path reads each frame's statistics before the next, as JAX's does. Every
solve (a frame's, or a level's of it) is ``solve_single_level``'s, in
``single_level.loop_for``'s kept loop of its shape, so each shape's CUDA
graph is captured once, and frames of later sequences or ``fuse_frame``
calls with the same solver reuse it.

Left out against JAX: its TPU resample clamps ±K, so JAX measures each
frame's max |u| against K and redoes a frame with K raised; the port's
resample is exact for any displacement, so there is no clamp, no redo and
no clamp check. ``FrameReport`` keeps those fields with JAX's values for
the exact gather (``pallas_max_displacement=0``); its
``contract_violations`` are the sharded fusion's live-halo ones
(``fuse_sequence_sharded``), else empty.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.core.camera import PinholeCamera
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.models.hierarchical import solve_hierarchical
from levelsetfusion_tpu_torch.models.params import HierarchicalParams, SolverParams
from levelsetfusion_tpu_torch.models.single_level import SolveResult, solve_single_level
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod, generate_tsdf_3d
from levelsetfusion_tpu_torch.parallel.halo import psum_axis
from levelsetfusion_tpu_torch.parallel.hierarchical import solve_hierarchical_sharded
from levelsetfusion_tpu_torch.parallel.mesh import (
    Group,
    Mesh2D,
    block_index,
    gather_field,
    shard_field,
)
from levelsetfusion_tpu_torch.parallel.sharded import (
    solve_single_level_sharded,
    warp_field_sharded,
)
from levelsetfusion_tpu_torch.parallel.sharded2d import (
    solve_single_level_sharded2d,
    warp_field_sharded2d,
)
from levelsetfusion_tpu_torch.utils.debug import check_displacement_contract
from levelsetfusion_tpu_torch.utils.profiling import span

TRUNCATION_EPS = 1e-5
_END = object()  # a frame source's end


class FusionState(NamedTuple):
    canonical: torch.Tensor  # (*spatial,) running fused TSDF
    weights: torch.Tensor  # (*spatial,) accumulated observation weights


class FrameReport(NamedTuple):
    frame_index: int
    solver_iterations: int
    final_data_energy: float
    band_voxels: int  # |Φ_c| < 1 count after fusion
    # Measured per-axis max |u| over every warp the frame's solve resampled
    # with (voxel units).
    max_abs_displacement: Tuple[float, ...] = ()
    # JAX's clamp fields, at their values for the exact gather.
    pallas_max_displacement: int | tuple = 0
    contract_violations: Tuple[str, ...] = ()


class FusionResult(NamedTuple):
    state: FusionState
    reports: List[FrameReport]
    final_warp: torch.Tensor


def blend(state: FusionState, warped_live: torch.Tensor) -> FusionState:
    """One truncation-aware weighted-average fusion update."""
    w_live = (torch.abs(warped_live) < 1.0 - TRUNCATION_EPS).to(warped_live.dtype)
    w_total = state.weights + w_live
    fused = torch.where(
        w_total > 0.0,
        (state.weights * state.canonical + w_live * warped_live)
        / torch.clamp(w_total, min=1e-12),
        state.canonical,
    )
    return FusionState(canonical=fused, weights=w_total)


def init_state(first_field: torch.Tensor) -> FusionState:
    w = (torch.abs(first_field) < 1.0 - TRUNCATION_EPS).to(first_field.dtype)
    return FusionState(canonical=first_field, weights=w)


@dataclasses.dataclass(frozen=True)
class FusionPipelineConfig:
    """Config for the multi-frame frame-to-canonical fusion."""

    grid: GridSpec
    narrow_band_width_voxels: int = 20
    generation_method: GenerationMethod = GenerationMethod.BASIC
    hierarchical: bool = True
    solver: SolverParams = SolverParams(learning_rate=1.0, convergence_threshold=1e-3)
    levels: int = 3
    warm_start: bool = True


def _call_frame_callback(cb, t, state, warp, report, solver) -> None:
    """Invoke a frame callback, passing ``report``/``solver`` keywords when
    the callback accepts them; plain ``(t, state, warp)`` callbacks keep
    working."""
    try:
        sig = inspect.signature(cb)
        params = sig.parameters.values()
        extended = any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params
        ) or {"report", "solver"} <= set(sig.parameters)
    except (TypeError, ValueError):
        extended = False
    if extended:
        cb(t, state, warp, report=report, solver=solver)
    else:
        cb(t, state, warp)


class _Frame(NamedTuple):
    """A dispatched frame: its device outputs, its iteration count (the
    solve's last flag read gave it) and its packed statistics, not yet read."""

    index: int
    state: FusionState
    warp: torch.Tensor
    iterations: int
    packed: torch.Tensor


def _pack_stats(res: SolveResult, state: FusionState) -> torch.Tensor:
    """The frame's statistics as one float64 device tensor, for its one host
    read: the band voxel count (int64 on the device, exact in float64 below
    2^53; f32 would round it past 2^24, 512³'s band), the last iteration's
    data energy and the per-axis max |u| (float32 values, exact)."""
    band = torch.count_nonzero(torch.abs(state.canonical) < 1.0 - TRUNCATION_EPS)
    energy = res.telemetry.data_energy[max(res.iterations - 1, 0)]
    return torch.cat([band.view(1).double(), energy.view(1).double(),
                      res.max_abs_displacement.double()])


def _depth_on(depth, device: torch.device) -> torch.Tensor:
    """A depth image (numpy, or a float32 CPU tensor such as the native
    prefetcher's pinned frames) on ``device``. A pinned tensor is copied
    with ``non_blocking``: the copy is queued on the current stream behind
    the previous frame's work and the host goes on."""
    if isinstance(depth, torch.Tensor):
        return depth.to(device, torch.float32, non_blocking=depth.is_pinned())
    return torch.as_tensor(np.asarray(depth, dtype=np.float32)).to(device)


def _tsdf(depth, camera: PinholeCamera, config: FusionPipelineConfig,
          device: torch.device, grid: GridSpec | None = None) -> torch.Tensor:
    """A depth image (see ``_depth_on``; meters) as a TSDF on ``device``,
    over ``config.grid`` or over ``grid`` (a rank's block of it)."""
    return generate_tsdf_3d(
        _depth_on(depth, device), camera,
        config.grid if grid is None else grid,
        narrow_band_width_voxels=config.narrow_band_width_voxels,
        method=config.generation_method,
    )


def _dispatch(t, live, prev_state, init_warp, config, solver) -> _Frame:
    """Frame t's program after TSDF generation: solve, resample, blend and
    the stats pack. Only the solve's flag reads wait for the device. The
    hierarchical solve's statistics are its finest level's."""
    if config.hierarchical:
        hres = solve_hierarchical(
            prev_state.canonical, live, HierarchicalParams(levels=config.levels, base=solver),
            initial_warp=init_warp)
        warp, res = hres.warp, hres.level_results[-1]
    else:
        res = solve_single_level(prev_state.canonical, live, solver, init_warp)
        warp = res.warp
    with span("lsf.frame.blend"):
        state = blend(prev_state, warp_field_cm(live, to_component_major(warp)))
        return _Frame(t, state, warp, res.iterations, _pack_stats(res, state))


def _report(frame: _Frame) -> FrameReport:
    """Read the frame's packed statistics (its one host read)."""
    with span("lsf.frame.report_read"):
        band, energy, *md = frame.packed.tolist()
    return FrameReport(
        frame_index=frame.index,
        solver_iterations=frame.iterations,
        final_data_energy=energy,
        band_voxels=int(band),
        max_abs_displacement=tuple(md),
    )


def fuse_frame(
    state: FusionState,
    live: torch.Tensor | None,
    init_warp: torch.Tensor,
    solver: SolverParams,
    config: FusionPipelineConfig,
    frame_index: int,
    depth=None,
    camera: PinholeCamera | None = None,
):
    """One fusion frame: solve (flat or hierarchical, as ``config`` says),
    resample, blend, then the stats read; with ``depth`` and ``camera`` the
    frame's TSDF is generated first (``live`` may be None then). Returns
    ``(state, warp, report, solver)``, as JAX's does."""
    device = state.canonical.device
    if depth is not None:
        live = _tsdf(depth, camera, config, device)
    frame = _dispatch(frame_index, live, state, init_warp, config, solver)
    return frame.state, frame.warp, _report(frame), solver


def fuse_sequence(
    frames,
    camera: PinholeCamera,
    config: FusionPipelineConfig,
    device="cuda",
    frame_callback: Callable[[int, FusionState, torch.Tensor], None] | None = None,
    pipelined: bool = True,
) -> FusionResult:
    """Fuse a depth sequence into a canonical TSDF on ``device``.

    ``frames`` is any iterable of depth images (numpy or float32 CPU
    tensors, meters), consumed in order, once: a list, or a frame source
    (``SequenceDataset.frame_source``), whose native prefetcher decodes
    frame t + 1 while frame t solves. ``frame_callback(t, state, warp)``
    runs after each frame's stats are read; callbacks that accept
    ``report``/``solver`` keywords also receive the frame's FrameReport and
    the solver.

    Pipelined (the default, JAX's flat loop): frame t + 1 is dispatched from
    frame t's device outputs before frame t's packed stats are read, so the
    read waits for nothing. ``pipelined=False`` reads each frame's stats
    before the next is dispatched: the serial loop the tests hold the
    pipelined one to. Both give the same reports and state. The
    hierarchical path always runs serially, as JAX's does.
    """
    device = torch.device(device)
    grid = config.grid
    frame_iter = iter(frames)

    def next_frame(*end):
        """The next depth image (else ``end``, where given)."""
        with span("lsf.frame.next"):
            return next(frame_iter, *end)

    state = init_state(_tsdf(next_frame(), camera, config, device))
    warp = torch.zeros((*grid.shape, grid.dim), dtype=torch.float32, device=device)
    pipelined = pipelined and not config.hierarchical
    reports: List[FrameReport] = []

    def emit(frame: _Frame) -> None:
        reports.append(_report(frame))
        if frame_callback is not None:
            _call_frame_callback(frame_callback, frame.index, frame.state, frame.warp,
                                 reports[-1], config.solver)

    pending = None
    t = 0
    while (depth := next_frame(_END)) is not _END:
        t += 1
        cur = _dispatch(t, _tsdf(depth, camera, config, device), state,
                        warp if config.warm_start else None, config, config.solver)
        state, warp = cur.state, cur.warp
        if pending is not None:
            emit(pending)
        pending = cur
        if not pipelined:
            emit(pending)
            pending = None
    if pending is not None:
        emit(pending)
    return FusionResult(state=state, reports=reports, final_warp=warp)


def _block_grid(grid: GridSpec, group) -> GridSpec:
    """The rank's block of ``grid`` (rows on a ``Group``, rows and columns
    on a ``Mesh2D``): the same voxel centres, so its TSDF is the rank's
    block of the whole grid's."""
    cuts = block_index(grid.shape, group)
    return dataclasses.replace(
        grid, shape=tuple(stop - start for start, stop in cuts),
        offset=tuple(o + start for o, (start, _) in zip(grid.offset, cuts)))


def blend_halo(max_u: float, live_halo: int) -> int:
    """The sharded blend's live halo, JAX's sizing: the slices a gather
    reads past a block's face, ceil(max |u| along the sharded axes) + 2,
    rounded up to a multiple of 4, and at least ``live_halo``."""
    return max(live_halo, (int(np.ceil(max_u)) + 2 + 3) // 4 * 4)


def fuse_sequence_sharded(
    frames,
    camera: PinholeCamera,
    config: FusionPipelineConfig,
    *,
    group: Group | Mesh2D,
    mesh_axes: tuple | None = None,
    live_halo: int = 8,
    frame_callback: Callable[[int, FusionState, torch.Tensor], None] | None = None,
) -> FusionResult:
    """Sharded twin of ``fuse_sequence``: the state, each frame's live TSDF
    and the warp stay the rank's blocks for the whole sequence, rows of axis
    0 on a ``Group``, or with ``mesh_axes=("x", "y")`` and a ``Mesh2D`` as
    ``group`` rows and columns (axes 0 and 1).

    - Each rank generates the TSDF of its own block.
    - The solve: ``parallel.sharded.solve_single_level_sharded`` (1D),
      ``parallel.sharded2d.solve_single_level_sharded2d`` (2D), or with
      ``config.hierarchical`` (1D only, as JAX's) the coarse-to-fine
      ``parallel.hierarchical.solve_hierarchical_sharded`` on the gathered
      fields, its fine levels sharded with halos sized from the measured
      coarse motion; warm-started per frame (``config.warm_start``).
    - The blend's resample is ``warp_field_sharded`` (``warp_field_sharded2d``)
      with its halo sized from the frame's measured max |u| along the
      sharded axes (``blend_halo``). Past one block it takes JAX's exact
      fallback: every rank gathers the live field and the warp
      (``all_gather``) and resamples the whole volume (B1 on CUDA).
    - The blend is elementwise on the blocks.
    - The report's ``contract_violations`` are the solve's live-halo ones
      on the sharded axes (per level against each level's halo in the
      hierarchical solve).

    Each frame reads the host twice, as JAX's does: the solve's energy and
    max |u| (they size the blend's halo), then the band count after the
    blend. The result's state and final warp are the rank's blocks.
    ``frame_callback`` gets the blocks.
    """
    two_d = mesh_axes is not None and len(mesh_axes) == 2
    if two_d and config.hierarchical:
        raise ValueError("hierarchical sharded fusion runs on the 1D mesh; set "
                         "hierarchical=False for the 2D voxel-block mesh")
    if two_d != isinstance(group, Mesh2D):
        raise ValueError(f"mesh_axes {mesh_axes} need a {'Mesh2D' if two_d else 'Group'}")
    axes = (0, 1) if two_d else (0,)
    device = group.device
    block = _block_grid(config.grid, group)
    frame_iter = iter(frames)
    state = init_state(_tsdf(next(frame_iter), camera, config, device, block))
    warp = torch.zeros((*block.shape, block.dim), dtype=torch.float32, device=device)
    solver = config.solver
    reports: List[FrameReport] = []
    for t, depth in enumerate(frame_iter, start=1):
        live = _tsdf(depth, camera, config, device, block)
        init_warp = warp if config.warm_start else None
        level_halos = None
        if config.hierarchical:
            hres = solve_hierarchical_sharded(
                gather_field(state.canonical, group), gather_field(live, group),
                HierarchicalParams(levels=config.levels, base=solver), group=group,
                min_live_halo=live_halo,
                initial_warp=None if init_warp is None else gather_field(init_warp, group))
            warp, res, level_halos = shard_field(hres.warp, group), hres.level_results[-1], \
                hres.level_halos
        elif two_d:
            res = solve_single_level_sharded2d(state.canonical, live, solver, mesh=group,
                                               live_halo=live_halo, initial_warp=init_warp)
            warp = res.warp
        else:
            res = solve_single_level_sharded(state.canonical, live, solver, group=group,
                                             live_halo=live_halo, initial_warp=init_warp)
            warp = res.warp
        energy = res.telemetry.data_energy[max(res.iterations - 1, 0)]
        energy, *md = torch.cat([energy.view(1), res.max_abs_displacement]).tolist()
        halo = blend_halo(max(md[a] for a in axes), live_halo)
        if halo > min(block.shape[a] for a in axes):
            # JAX's exact gather fallback: the whole volume on every rank.
            cuts = block_index(config.grid.shape, group)
            warped = warp_field_cm(
                gather_field(live, group), to_component_major(gather_field(warp, group)))
            for a in axes:
                warped = warped.narrow(a, cuts[a][0], block.shape[a])
            warped = warped.contiguous()
        elif two_d:
            warped = warp_field_sharded2d(live, warp, group, halo)
        else:
            warped = warp_field_sharded(live, warp, group, halo)
        state = blend(state, warped)
        band = psum_axis(torch.count_nonzero(
            torch.abs(state.canonical) < 1.0 - TRUNCATION_EPS).view(1), group)
        if level_halos is not None:
            violations = [v for li, (lres, lh) in enumerate(zip(hres.level_results, level_halos))
                          if lh is not None
                          for v in check_displacement_contract(
                              lres, live_halo=lh, name=f"sharded fusion frame {t} level {li}")]
        else:
            violations = check_displacement_contract(
                res, live_halo=live_halo, sharded_axes=axes, name=f"sharded fusion frame {t}")
        reports.append(FrameReport(
            frame_index=t,
            solver_iterations=res.iterations,
            final_data_energy=energy,
            band_voxels=int(band),
            max_abs_displacement=tuple(md),
            contract_violations=tuple(violations),
        ))
        if frame_callback is not None:
            _call_frame_callback(frame_callback, t, state, warp, reports[-1], solver)
    return FusionResult(state=state, reports=reports, final_warp=warp)
