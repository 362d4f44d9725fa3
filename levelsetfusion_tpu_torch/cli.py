"""Experiment runner + CLI. Twin of ``levelsetfusion_tpu/cli.py``.

Usage:
    python -m levelsetfusion_tpu_torch.cli --list
    python -m levelsetfusion_tpu_torch.cli --preset config1_2d_pair --out runs/c1
    python -m levelsetfusion_tpu_torch.cli --preset config3_3d_full_energy --out runs/c3
    python -m levelsetfusion_tpu_torch.cli --preset config4_3d_fusion --out runs/c4 [--resume]
    python -m levelsetfusion_tpu_torch.cli --config my_config.json --out runs/x --device cuda
    python -m levelsetfusion_tpu_torch.cli --preset config1_2d_pair --out runs/c1 --verbose \
        --profile --check-nans

A run writes config.json, telemetry.csv, events.jsonl and summary.json, with
the JAX run's keys, less its TPU fast-path and clamp-contract entries and
plus the device and the CUDA kernels' launch counts, and JAX's plots
(``utils/visualization.py``: energy, field and warp PNGs; a multi-frame
run's ``canonical_evolution.mp4``). Where matplotlib (or, for the video,
cv2) is missing, as on the H100's machine, an ``artifacts_skipped`` event
names the module and the files not written, and the run is otherwise the
same. ``--verbose`` echoes the telemetry and logs a ``focus_voxel`` event
at the voxel of the largest band residual (reduced on the device);
``--profile`` writes a ``torch.profiler`` trace to ``<out>/trace/``, with
the program's spans in it, and its counters into the summary
(``counters``); ``utils/profiling.py``'s docstring lists both.

``--check-nans`` runs every single-device solve serially, checked for NaN
and Inf each iteration (``utils/debug.py::nan_checks``).

The single-device modes run: ``single_pair_2d`` (config1) and
``single_pair_3d`` (config3), ``hierarchical_2d`` (config2: coarse-to-fine
over a block-mean or an EWA depth pyramid), ``rigid_2d`` and ``rigid_3d``
(SDF-2-SDF pose recovery against a known extrinsic), and ``multi_frame_3d``
(config4: the flat fusion of a depth sequence, synthetic or a
``depth_directory`` of 16-bit PNGs decoded ahead by the native prefetcher,
with checkpoints every ``checkpoint_every`` frames under
``<out>/checkpoints`` and ``--resume`` from the latest).

The sharded modes run on ``torch.distributed`` (``parallel/``):
``sharded_3d`` with the sync solver (config5_sharded, config5_512), the
Schur solver (``solver_kind="schur"``, config5_sharded_schur), the 2D-mesh
sync solver (a ``mesh_shape``, config5_2dmesh) and the Schur-2D solver
(``mesh_shape`` and ``solver_kind="schur2d"``, config5_schur2d);
``hierarchical_sharded_3d`` (config5_hierarchical: coarse levels
replicated, fine levels sharded, on the 1D or the 2D mesh); and
``multi_frame_sharded_3d`` (the flat fusion on either mesh, its checkpoints
sharded). The world size comes from ``torchrun``'s environment, else it is
1 (one process, no launcher); ``num_devices`` is not read, and a
``mesh_shape`` must hold the world's ranks (``(1, 1)`` for one). Rank 0
writes the run's files; every rank writes its checkpoint shards:

    python -m levelsetfusion_tpu_torch.cli --preset config5_512 --out c5
    torchrun --nproc-per-node 2 -m levelsetfusion_tpu_torch.cli --preset config5_sharded --out c5
    torchrun --nproc-per-node 8 -m levelsetfusion_tpu_torch.cli --preset config5_2dmesh --out c5
    python -m levelsetfusion_tpu_torch.cli --config c5_2dmesh_1x1.json --out c5
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from levelsetfusion_tpu_torch.core.camera import PinholeCamera, se2_matrix
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import datasets, synthetic
from levelsetfusion_tpu_torch.models.fusion import (
    FusionPipelineConfig,
    FusionResult,
    _call_frame_callback,
    fuse_frame,
    fuse_sequence,
    fuse_sequence_sharded,
)
from levelsetfusion_tpu_torch.models.hierarchical import (
    build_pyramid_from_depth,
    solve_hierarchical,
    solve_hierarchical_from_depth,
)
from levelsetfusion_tpu_torch.models.params import HierarchicalParams
from levelsetfusion_tpu_torch.models.rigid import solve_rigid_2d, solve_rigid_3d
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, loop_tail, resample, step2d
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d, generate_tsdf_3d
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
from levelsetfusion_tpu_torch.parallel.mesh import Mesh2D, gather_field, shard_field
from levelsetfusion_tpu_torch.utils import checkpoint, visualization
from levelsetfusion_tpu_torch.utils.config import PRESETS, ExperimentConfig
from levelsetfusion_tpu_torch.utils.debug import check_displacement_contract, nan_checks
from levelsetfusion_tpu_torch.utils.profiling import counters, trace
from levelsetfusion_tpu_torch.utils.telemetry import RunLogger, telemetry_to_rows


def _device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but CUDA is not available "
            "(pass --device cpu for the plain torch path)"
        )
    return device


def _grid(cfg: ExperimentConfig) -> GridSpec:
    return GridSpec(
        shape=cfg.grid_shape, voxel_size=cfg.voxel_size, offset=cfg.grid_offset
    )


def _residual_metrics(canonical, live, warped) -> dict:
    """Accuracy gate: mean |Φ − Φ_c| over the narrow-band union, before
    (live) and after (warped live) the solve, reduced on the device."""
    band = (torch.abs(canonical) < 1.0 - 1e-5) | (torch.abs(live) < 1.0 - 1e-5)
    n = torch.clamp(torch.sum(band), min=1).to(canonical.dtype)
    r0 = torch.sum(torch.where(band, torch.abs(live - canonical), 0.0)) / n
    r1 = torch.sum(torch.where(band, torch.abs(warped - canonical), 0.0)) / n
    r0, r1 = (float(v) for v in torch.stack([r0, r1]).cpu())
    return {
        "residual_before": r0,
        "residual_after": r1,
        "residual_reduction": r0 / max(r1, 1e-12),
    }


def _artifacts(logger: RunLogger, rows=(), **fields) -> None:
    """JAX's plots of a run (``write_run_artifacts``) into the run's
    directory, or, where matplotlib is missing, an ``artifacts_skipped``
    event naming it and the files not written."""
    missing = visualization.missing_modules(visualization.PLOT_MODULES)
    if missing:
        logger.event("artifacts_skipped", missing=missing,
                     files=visualization.artifact_files(rows, **fields))
        return
    visualization.write_run_artifacts(logger.out_dir, list(rows), **fields)


def _video(logger: RunLogger):
    """The fusion's ``canonical_evolution.mp4`` writer, or None with an
    ``artifacts_skipped`` event where matplotlib or cv2 is missing."""
    missing = visualization.missing_modules(visualization.VIDEO_MODULES)
    if missing:
        logger.event("artifacts_skipped", missing=missing, files=["canonical_evolution.mp4"])
        return None
    return visualization.FieldEvolutionVideo(
        os.path.join(logger.out_dir, "canonical_evolution.mp4"))


def _log_focus(logger: RunLogger, canonical, live, warped, warp) -> None:
    """The focus-coordinate deep dive of a ``--verbose`` run: every logged
    field at the voxel with the largest post-solve band residual. The
    argmax and the values there are taken on the device; the coordinates
    and one scalar a field come back in one read."""
    d = canonical.ndim
    band = (torch.abs(canonical) < 1 - 1e-5) | (torch.abs(live) < 1 - 1e-5)
    resid = torch.where(band, torch.abs(warped - canonical), 0.0)
    coords = torch.unravel_index(torch.argmax(resid), canonical.shape)
    vals = [canonical[coords], live[coords], warped[coords],
            *(warp[..., a][coords] for a in range(d))]
    packed = torch.stack([*(c.to(torch.float64) for c in coords),
                          *(v.to(torch.float64) for v in vals)]).tolist()
    fields = {"canonical": packed[d], "live": packed[d + 1], "warped_live": packed[d + 2]}
    for ax in range(d):
        fields[f"warp_u{ax}"] = packed[d + 3 + ax]
    logger.focus_voxel("max_band_residual", [int(c) for c in packed[:d]], **fields)


def _pair_2d(cfg: ExperimentConfig, grid: GridSpec, device: torch.device):
    """The synthetic bump-on-a-wall scanline pair as canonical and live
    TSDFs, and the pair itself."""
    kwargs = dict(width=128, bump_height=0.04, bump_radius_px=20.0, live_shift_px=4.0)
    kwargs.update(cfg.dataset_kwargs)
    pair = synthetic.bump_wall_pair_2d(**kwargs)

    def gen(depth: np.ndarray) -> torch.Tensor:
        return generate_tsdf_2d(
            torch.from_numpy(depth).to(device), pair.camera, grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            method=cfg.generation_method,
        )

    return gen(pair.canonical_depth), gen(pair.live_depth), pair


def _pair_3d(cfg: ExperimentConfig, grid: GridSpec, device: torch.device,
             depths: bool = False):
    """The synthetic blob-on-a-wall depth pair as canonical and live TSDFs
    (with ``depths``, also the two depth images and the camera)."""
    kwargs = dict(blob_height=0.06, blob_radius_px=18.0)
    kwargs.update(cfg.dataset_kwargs)
    shift = kwargs.pop("live_shift_px", 4.0)
    cam = synthetic.default_camera_3d(128, 128)
    canonical_depth = synthetic.blob_wall_depth_3d(cam, **kwargs)
    live_depth = synthetic.blob_wall_depth_3d(
        cam,
        blob_center_px=(64.0 + shift, 64.0),
        **kwargs,
    )

    def gen(depth: np.ndarray) -> torch.Tensor:
        return generate_tsdf_3d(
            torch.from_numpy(depth).to(device), cam, grid,
            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
            method=cfg.generation_method,
        )

    pair = gen(canonical_depth), gen(live_depth)
    return (*pair, (canonical_depth, live_depth, cam)) if depths else pair


def _sequence_dataset(cfg: ExperimentConfig) -> datasets.SequenceDataset:
    """Resolve cfg.dataset through the registry. "synthetic" keeps JAX's
    inline generator with its CLI defaults; any other name comes from
    ``io/datasets.py``."""
    if cfg.dataset in ("synthetic", "synthetic_snoopy"):
        seq_kwargs = dict(width=48, height=48, blob_radius_px=10.0,
                          blob_height=0.05, drift_px_per_frame=(1.5, 0.0),
                          pulse_amplitude=0.1)
        seq_kwargs.update(cfg.dataset_kwargs)
        seq = synthetic.snoopy_style_sequence_3d(cfg.num_frames, **seq_kwargs)
        return datasets.SequenceDataset("synthetic_snoopy", seq.camera, list(seq.frames))
    return datasets.get(cfg.dataset, **cfg.dataset_kwargs)


def _launches(before: dict) -> dict:
    """The kernels' launches since ``before`` (a ``_launches({})``)."""
    now = {"resample": resample.launch_count, "fused_gradient": fused_gradient.launch_count,
           "step2d": step2d.launch_count, "loop_tail": loop_tail.launch_count}
    return {k: v - before.get(k, 0) for k, v in now.items()}


def _counters() -> dict:
    """Under ``--profile`` (a profiler running): the program's counters."""
    if not torch._C._autograd._profiler_enabled():
        return {}
    return {"counters": counters()}


def _resume_fusion(state, warp, frames, camera, pipeline_cfg, on_frame, frame_offset):
    """Continue a fusion run from checkpointed state over the remaining
    frames. ``frames`` starts AT the checkpointed frame (whose TSDF is
    already blended into ``state``), so its first frame is skipped."""
    frame_iter = iter(frames)
    next(frame_iter, None)  # the checkpointed frame itself
    reports = []
    solver = pipeline_cfg.solver
    for j, frame in enumerate(frame_iter, start=1):
        t = frame_offset + j
        state, warp, report, solver = fuse_frame(
            state, None, warp, solver, pipeline_cfg, t, depth=frame, camera=camera)
        reports.append(report)
        _call_frame_callback(on_frame, t, state, warp, report, solver)
    return FusionResult(state=state, reports=reports, final_warp=warp)


def _multi_frame_3d(cfg, out_dir, logger, device, resume) -> dict:
    """config4: fuse a depth sequence (synthetic, or a ``depth_directory``
    read through its frame source), checkpointing every
    ``cfg.checkpoint_every`` frames; ``resume`` continues from the latest
    checkpoint under ``<out_dir>/checkpoints``, reading the same source
    from that frame. The video gets each fused frame's canonical (its
    central y slice)."""
    before = _launches({})
    ds = _sequence_dataset(cfg)
    n_frames = len(ds)
    pipeline_cfg = FusionPipelineConfig(
        grid=_grid(cfg),
        narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        generation_method=cfg.generation_method,
        hierarchical=False,
        solver=cfg.solver,
    )
    ckpt_root = os.path.join(out_dir, "checkpoints")
    start_frame = 0
    if resume:
        latest = checkpoint.latest_frame(ckpt_root)
        if latest is not None:
            if latest >= n_frames - 1:
                # Nothing left to fuse: the final artifacts from the checkpoint.
                logger.event("resume_noop", frame=latest)
                state, warp, _ = checkpoint.load(ckpt_root, latest, device)
                _artifacts(logger, canonical=state.canonical, warp=warp)
                return logger.finish(frames=0, resumed_from=latest,
                                     note="checkpoint already covers the full sequence",
                                     **_counters())
            start_frame = latest
            logger.event("resumed", frame=latest)

    frame_times = []
    video = _video(logger)

    def on_frame(t, state, warp, report, solver):
        frame_times.append(time.perf_counter())
        if video is not None:
            video.add_frame(state.canonical[:, state.canonical.shape[1] // 2])
        logger.event("frame_fused", frame=t, band_voxels=report.band_voxels)
        if cfg.checkpoint_every and t % cfg.checkpoint_every == 0:
            checkpoint.save(ckpt_root, t, state, warp, {"config": cfg.name})

    try:
        if start_frame > 0:
            state, warp, _ = checkpoint.load(ckpt_root, start_frame, device)
            result = _resume_fusion(state, warp, ds.frame_source(start_frame), ds.camera,
                                    pipeline_cfg, on_frame, start_frame)
        else:
            result = fuse_sequence(ds.frame_source(), ds.camera, pipeline_cfg, device=device,
                                   frame_callback=on_frame)
    finally:
        if video is not None:
            video.close()
    _artifacts(logger, canonical=result.state.canonical, warp=result.final_warp)
    if cfg.checkpoint_every:
        checkpoint.save(ckpt_root, n_frames - 1, result.state, result.final_warp,
                        {"config": cfg.name, "final": True})
    # frames/s counts only the frames this run processed, and measures from
    # the second fused frame on: the first carries the kernels' build and the
    # graph's capture.
    processed = n_frames - start_frame
    if len(frame_times) >= 2:
        fps = (len(frame_times) - 1) / max(frame_times[-1] - frame_times[0], 1e-9)
    else:
        fps = processed / max(logger.elapsed(), 1e-9)
    mds = [r.max_abs_displacement for r in result.reports]
    return logger.finish(
        frames=n_frames,
        dataset=ds.name,
        frames_processed=processed,
        frames_per_s=round(fps, 3),
        frames_per_s_incl_compile=round(processed / max(logger.elapsed(), 1e-9), 3),
        reports=[r._asdict() for r in result.reports],
        max_abs_displacement=[float(v) for v in np.max(mds, axis=0)] if mds else None,
        device=str(device),
        kernel_launches=_launches(before),
        **_counters(),
    )


def _single_pair(cfg, logger, device) -> dict:
    """config1 (2D) or config3 (3D): one solve of the synthetic pair."""
    grid = _grid(cfg)
    if cfg.mode == "single_pair_2d":
        canonical, live, _ = _pair_2d(cfg, grid, device)
    else:
        canonical, live = _pair_3d(cfg, grid, device)
    res = solve_single_level(canonical, live, cfg.solver)
    logger.log_solve(res)
    warped = warp_field_cm(live, to_component_major(res.warp))
    if logger.verbose:
        _log_focus(logger, canonical, live, warped, res.warp)
    rows = telemetry_to_rows(res.telemetry, res.iterations)
    _artifacts(logger, rows, canonical=canonical, live=live, warped=warped, warp=res.warp)
    return dict(
        iterations=int(res.iterations),
        converged=bool(res.converged),
        final_data_energy=rows[-1]["data_energy"] if rows else None,
        **_residual_metrics(canonical, live, warped),
        max_abs_displacement=[float(v) for v in res.max_abs_displacement.cpu()],
    )


def _hierarchical_2d(cfg, logger, device) -> dict:
    """config2: the coarse-to-fine solve of the 2D pair, its coarse levels
    block means of the finest TSDFs or (``pyramid_method="ewa_depth"``)
    generated from the depth with EWA on coarsened grids."""
    grid = _grid(cfg)
    canonical, live, pair = _pair_2d(cfg, grid, device)
    hp = HierarchicalParams(levels=cfg.levels, base=cfg.solver)
    if cfg.pyramid_method == "ewa_depth":
        res = solve_hierarchical_from_depth(
            torch.from_numpy(pair.canonical_depth).to(device),
            torch.from_numpy(pair.live_depth).to(device),
            pair.camera, grid, hp, narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        )
    else:
        res = solve_hierarchical(canonical, live, hp)
    rows = []
    for level, lr in enumerate(res.level_results):
        logger.log_solve(lr, level=level)
        rows += telemetry_to_rows(lr.telemetry, lr.iterations)
    warped = warp_field_cm(live, to_component_major(res.warp))
    _artifacts(logger, rows, canonical=canonical, live=live, warped=warped, warp=res.warp)
    finest = res.level_results[-1]
    return dict(
        levels=cfg.levels,
        iterations_per_level=[int(r.iterations) for r in res.level_results],
        converged=bool(finest.converged),
        **_residual_metrics(canonical, live, warped),
        max_abs_displacement=[float(v) for v in finest.max_abs_displacement.cpu()],
    )


def _rigid_depth_3d(cfg) -> tuple:
    """rigid_3d's depth image and camera: a narrow camera (the grid covers
    the blob and the wall around it) on TWO blobs, so that no rotation
    about a blob's axis leaves the energy unchanged and all six DoF are
    pinned."""
    kwargs = dict(wall_depth=0.4, blob_radius_px=10.0, blob_height=0.06)
    kwargs.update(cfg.dataset_kwargs)
    cam = PinholeCamera(fx=48.0, fy=48.0, cx=24.0, cy=24.0, image_width=48, image_height=48)
    second = {**kwargs, "blob_radius_px": kwargs["blob_radius_px"] * 0.6,
              "blob_height": kwargs["blob_height"] * 0.7, "blob_center_px": (14.0, 31.0)}
    depth = np.minimum(synthetic.blob_wall_depth_3d(cam, **kwargs),
                       synthetic.blob_wall_depth_3d(cam, **second))
    return depth, cam


def _rigid(cfg, logger, device) -> dict:
    """rigid_2d / rigid_3d: the canonical TSDF is generated under a known
    extrinsic, and SDF-2-SDF recovers it from the identity; the summary
    holds the pose error against that truth."""
    grid = _grid(cfg)
    if cfg.mode == "rigid_2d":
        kwargs = dict(width=128, bump_height=0.04, live_shift_px=0.0)
        kwargs.update(cfg.dataset_kwargs)
        pair = synthetic.bump_wall_pair_2d(**kwargs)
        depth = torch.from_numpy(pair.canonical_depth).to(device)
        true_ext = torch.from_numpy(se2_matrix(0.02, 0.008, 0.004)).to(device)
        canonical = generate_tsdf_2d(depth, pair.camera, grid, extrinsic=true_ext)
        res = solve_rigid_2d(canonical, depth, pair.camera, grid)
    else:
        depth_np, cam = _rigid_depth_3d(cfg)
        depth = torch.from_numpy(depth_np).to(device)
        true_ext = torch.eye(4, device=device)
        true_ext[0, 3], true_ext[2, 3] = 0.012, -0.008
        nb = cfg.narrow_band_width_voxels
        canonical = generate_tsdf_3d(depth, cam, grid, extrinsic=true_ext,
                                     narrow_band_width_voxels=nb)
        res = solve_rigid_3d(canonical, depth, cam, grid, narrow_band_width_voxels=nb)
    _artifacts(logger, canonical=canonical, live=res.final_live)
    true_np, est = true_ext.cpu().numpy(), res.extrinsic.cpu().numpy()
    e = res.energies.cpu().numpy()
    return dict(
        true_extrinsic=true_np.tolist(),
        estimated_extrinsic=est.tolist(),
        pose_error=float(np.max(np.abs(est - true_np))),
        initial_energy=float(e[0]),
        final_energy=float(e[-1]),
    )


def _sharded_3d(cfg, out_dir, logger, mesh) -> dict:
    """config5: the sync or Schur solver on the 1D group, or with a
    ``mesh_shape`` the 2D-mesh sync or Schur-2D solver. Every rank makes the
    whole pair and keeps its block; the summary holds JAX's keys (the
    residuals over the whole volume, the per-axis max |u|, the live-halo
    violations on the sharded axes, and the Schur solvers' step counts)."""
    canonical, live = _pair_3d(cfg, _grid(cfg), mesh.device)
    live_blk = shard_field(live, mesh)
    args = (shard_field(canonical, mesh), live_blk, cfg.solver)
    schur = dict(live_halo=cfg.live_halo, inner_iterations=cfg.schur_inner_iterations)
    if isinstance(mesh, Mesh2D):
        if cfg.solver_kind == "schur2d":
            res = solve_single_level_schur2d(*args, mesh=mesh, **schur)
        else:
            res = solve_single_level_sharded2d(*args, mesh=mesh, live_halo=cfg.live_halo)
        # The whole volume's gather, as JAX's 2D-mesh runs take it.
        warped = warp_field_cm(live, to_component_major(gather_field(res.warp, mesh)))
    else:
        if cfg.solver_kind == "schur":
            res = solve_single_level_schur(*args, group=mesh, **schur)
        else:
            res = solve_single_level_sharded(*args, group=mesh, live_halo=cfg.live_halo)
        warped = gather_field(warp_field_sharded(live_blk, res.warp, mesh, cfg.live_halo),
                              mesh)
    logger.log_solve(res)
    # The warp's gather is collective (every rank takes the same branch);
    # rank 0 logs and draws.
    warp = res.warp
    if logger.verbose or not visualization.missing_modules():
        warp = gather_field(warp.contiguous(), mesh)
    if mesh.rank == 0:
        if logger.verbose:
            _log_focus(logger, canonical, live, warped, warp)
        _artifacts(logger, telemetry_to_rows(res.telemetry, res.iterations),
                   canonical=canonical, live=live, warp=warp)
    extra = {}
    if hasattr(res, "outer_steps"):
        extra = dict(solver_kind=cfg.solver_kind, outer_steps=res.outer_steps,
                     inner_per_outer=res.inner_per_outer,
                     total_inner_iterations=res.outer_steps * res.inner_per_outer)
    return dict(
        devices=mesh.world,
        iterations=int(res.iterations),
        converged=bool(res.converged),
        **_residual_metrics(canonical, live, warped),
        max_abs_displacement=[float(v) for v in res.max_abs_displacement.cpu()],
        contract_violations=check_displacement_contract(
            res, live_halo=cfg.live_halo, sharded_axes=_sharded_axes(mesh), name=cfg.name),
        **extra,
    )


def _sharded_axes(mesh) -> tuple:
    return (0, 1) if isinstance(mesh, Mesh2D) else (0,)


def _hierarchical_sharded_3d(cfg, out_dir, logger, mesh) -> dict:
    """config5 x the hierarchical solve: coarse levels replicated, fine
    levels sharded on the 1D group or the 2D mesh, their halos sized from
    the measured coarse motion (``parallel/hierarchical.py``), over
    block-mean or EWA depth pyramids. Each level's contract is checked
    against the halo it ran with."""
    grid = _grid(cfg)
    canonical, live, (cdepth, ldepth, cam) = _pair_3d(cfg, grid, mesh.device, depths=True)
    hp = HierarchicalParams(levels=cfg.levels, base=cfg.solver)
    pyramids = None
    if cfg.pyramid_method == "ewa_depth":
        pyramids = tuple(build_pyramid_from_depth(
            torch.from_numpy(depth).to(mesh.device), cam, grid, cfg.levels,
            cfg.narrow_band_width_voxels)[0] for depth in (cdepth, ldepth))
    res = solve_hierarchical_sharded(canonical, live, hp, group=mesh,
                                     min_live_halo=cfg.live_halo, pyramids=pyramids)
    rows = []
    for level, lr in enumerate(res.level_results):
        logger.log_solve(lr, level=level)
        rows += telemetry_to_rows(lr.telemetry, lr.iterations)
    warped = warp_field_cm(live, to_component_major(res.warp))
    if mesh.rank == 0:
        _artifacts(logger, rows, canonical=canonical, live=live, warped=warped, warp=res.warp)
    violations = []
    for li, (lr, lh) in enumerate(zip(res.level_results, res.level_halos)):
        if lh is not None:
            violations += [f"level {li}: {v}" for v in check_displacement_contract(
                lr, live_halo=lh, sharded_axes=_sharded_axes(mesh), name=cfg.name)]
    finest = res.level_results[-1]
    return dict(
        devices=mesh.world,
        levels=cfg.levels,
        iterations_per_level=[int(r.iterations) for r in res.level_results],
        level_live_halos=list(res.level_halos),
        converged=bool(finest.converged),
        **_residual_metrics(canonical, live, warped),
        max_abs_displacement=[float(v) for v in finest.max_abs_displacement.cpu()],
        contract_violations=violations,
    )


def _multi_frame_sharded_3d(cfg, out_dir, logger, group) -> dict:
    """config4 on the 1D group or the 2D mesh (``fuse_sequence_sharded``),
    with sharded checkpoints every ``checkpoint_every`` frames under
    ``<out>/checkpoints``."""
    ds = _sequence_dataset(cfg)
    pipeline_cfg = FusionPipelineConfig(
        grid=_grid(cfg),
        narrow_band_width_voxels=cfg.narrow_band_width_voxels,
        generation_method=cfg.generation_method,
        hierarchical=False,
        solver=cfg.solver,
    )
    ckpt_root = os.path.join(out_dir, "checkpoints")
    frame_times = []

    def on_frame(t, state, warp, report, solver):
        frame_times.append(time.perf_counter())
        logger.event("frame_fused", frame=t, band_voxels=report.band_voxels)
        if cfg.checkpoint_every and t % cfg.checkpoint_every == 0:
            checkpoint.save(ckpt_root, t, state, warp, {"config": cfg.name}, group=group)

    result = fuse_sequence_sharded(
        ds.frame_source(), ds.camera, pipeline_cfg, group=group,
        mesh_axes=("x", "y") if isinstance(group, Mesh2D) else None,
        live_halo=cfg.live_halo, frame_callback=on_frame)
    state, warp = result.state.canonical, result.final_warp
    if not visualization.missing_modules():
        state, warp = gather_field(state, group), gather_field(warp.contiguous(), group)
    if group.rank == 0:
        _artifacts(logger, canonical=state, warp=warp)
    processed = len(ds)
    if len(frame_times) >= 2:
        fps = (len(frame_times) - 1) / max(frame_times[-1] - frame_times[0], 1e-9)
    else:
        fps = processed / max(logger.elapsed(), 1e-9)
    mds = [r.max_abs_displacement for r in result.reports]
    return dict(
        frames=processed,
        devices=group.world,
        frames_per_s=round(fps, 3),
        reports=[r._asdict() for r in result.reports],
        max_abs_displacement=[float(v) for v in np.max(mds, axis=0)] if mds else None,
        contract_violations=[v for r in result.reports for v in r.contract_violations],
    )


_MODES = {"single_pair_2d": _single_pair, "single_pair_3d": _single_pair,
          "hierarchical_2d": _hierarchical_2d, "rigid_2d": _rigid, "rigid_3d": _rigid}
_SHARDED = {"sharded_3d": _sharded_3d, "multi_frame_sharded_3d": _multi_frame_sharded_3d,
            "hierarchical_sharded_3d": _hierarchical_sharded_3d}


def _run_sharded(cfg, out_dir, device, verbose) -> dict:
    """A sharded mode on the default process group (``init_group``: made
    here for a world of 1 without a launcher, and taken down after), as a
    1D group or, with a ``mesh_shape``, a 2D mesh over it. Rank 0 writes the
    run's files into ``out_dir``; the other ranks log into a directory that
    is removed."""
    group = init_group(device)
    try:
        mesh = group if cfg.mesh_shape is None else make_mesh_2d(group, cfg.mesh_shape)
        with contextlib.ExitStack() as stack:
            log_dir = out_dir if group.rank == 0 else stack.enter_context(
                tempfile.TemporaryDirectory())
            logger = _logger(cfg, log_dir, verbose)
            before = _launches({})
            summary = _SHARDED[cfg.mode](cfg, out_dir, logger, mesh)
            return logger.finish(**summary, device=str(group.device),
                                 kernel_launches=_launches(before), **_counters())
    finally:
        close_group(group)


def _logger(cfg, out_dir, verbose=False) -> RunLogger:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return RunLogger(out_dir, verbose=verbose)


def run_experiment(cfg: ExperimentConfig, out_dir: str, device="cuda",
                   resume: bool = False, verbose: bool = False) -> dict:
    """Run one experiment into ``out_dir``; returns the summary. ``resume``
    (multi_frame_3d) continues from the latest checkpoint there;
    ``verbose`` echoes the telemetry and logs the focus voxel (the
    single-pair modes and ``sharded_3d``, as JAX's)."""
    if cfg.mode not in (*_MODES, *_SHARDED, "multi_frame_3d"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    device = _device(device)
    if cfg.mode in _SHARDED:
        return _run_sharded(cfg, out_dir, device, verbose)
    logger = _logger(cfg, out_dir, verbose)
    if cfg.mode == "multi_frame_3d":
        return _multi_frame_3d(cfg, out_dir, logger, device, resume)
    before = _launches({})
    summary = _MODES[cfg.mode](cfg, logger, device)
    return logger.finish(**summary, device=str(device), kernel_launches=_launches(before),
                         **_counters())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), help="named config")
    ap.add_argument("--config", help="path to an ExperimentConfig JSON file")
    ap.add_argument("--out", default=None, help="output run directory")
    ap.add_argument("--resume", action="store_true",
                    help="multi_frame_3d: continue from the latest checkpoint in --out")
    ap.add_argument("--verbose", action="store_true",
                    help="echo the telemetry and log the focus voxel")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; fails if CUDA is absent)",
    )
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of the run under <out>/trace/")
    ap.add_argument("--check-nans", action="store_true",
                    help="run each single-device solve serially, checked for NaN/Inf every "
                    "iteration (slow; for debugging diverging solves)")
    args = ap.parse_args(argv)

    if args.list:
        for name, cfg in sorted(PRESETS.items()):
            print(f"{name:28s} mode={cfg.mode:18s} grid={cfg.grid_shape}")
        return 0

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        ap.error("need --preset or --config")
    out = args.out or os.path.join("runs", cfg.name)
    with contextlib.ExitStack() as stack:
        if args.check_nans:
            stack.enter_context(nan_checks())
        if args.profile:
            stack.enter_context(trace(os.path.join(out, "trace")))
        summary = run_experiment(cfg, out, device=args.device, resume=args.resume,
                                 verbose=args.verbose)
    print(f"run complete -> {out}")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
