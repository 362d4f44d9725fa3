"""Experiment runner + CLI. Twin of ``levelsetfusion_tpu/cli.py``.

Usage:
    python -m levelsetfusion_tpu_torch.cli --list
    python -m levelsetfusion_tpu_torch.cli --preset config3_3d_full_energy --out runs/c3
    python -m levelsetfusion_tpu_torch.cli --config my_config.json --out runs/x --device cuda

A run writes config.json, telemetry.csv, events.jsonl and summary.json, with
the JAX run's keys, less its TPU fast-path entries and plus the CUDA kernels'
launch counts. This slice runs the ``single_pair_3d`` mode; the other modes
raise ``NotImplementedError`` naming their ROADMAP item. Plots wait for the
port of ``utils/visualization.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, resample
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_3d
from levelsetfusion_tpu_torch.utils.config import PRESETS, ExperimentConfig
from levelsetfusion_tpu_torch.utils.telemetry import RunLogger, telemetry_to_rows

# Modes of the JAX CLI that this package does not run yet, by ROADMAP item.
_NOT_PORTED = {
    "single_pair_2d": "A8",
    "hierarchical_2d": "A8",
    "rigid_2d": "A8",
    "rigid_3d": "A8",
    "multi_frame_3d": "A7",
    "sharded_3d": "A11/A12",
    "multi_frame_sharded_3d": "A11",
    "hierarchical_sharded_3d": "A12",
}


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


def _pair_3d(cfg: ExperimentConfig, grid: GridSpec, device: torch.device):
    """The synthetic blob-on-a-wall depth pair as canonical and live TSDFs."""
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

    return gen(canonical_depth), gen(live_depth)


def run_experiment(cfg: ExperimentConfig, out_dir: str, device="cuda") -> dict:
    """Run one experiment into ``out_dir``; returns the summary."""
    if cfg.mode != "single_pair_3d":
        item = _NOT_PORTED.get(cfg.mode)
        raise NotImplementedError(
            f"mode {cfg.mode!r} is not ported yet"
            + (f" (ROADMAP {item})" if item else "")
        )
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    logger = RunLogger(out_dir)
    resample_before = resample.launch_count
    fused_before = fused_gradient.launch_count

    canonical, live = _pair_3d(cfg, _grid(cfg), device)
    res = solve_single_level(canonical, live, cfg.solver)
    logger.log_solve(res)
    warped = warp_field_cm(live, to_component_major(res.warp))
    rows = telemetry_to_rows(res.telemetry, res.iterations)
    return logger.finish(
        iterations=int(res.iterations),
        converged=bool(res.converged),
        final_data_energy=rows[-1]["data_energy"] if rows else None,
        **_residual_metrics(canonical, live, warped),
        max_abs_displacement=[float(v) for v in res.max_abs_displacement.cpu()],
        device=str(device),
        kernel_launches={
            "resample": resample.launch_count - resample_before,
            "fused_gradient": fused_gradient.launch_count - fused_before,
        },
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=sorted(PRESETS), help="named config")
    ap.add_argument("--config", help="path to an ExperimentConfig JSON file")
    ap.add_argument("--out", default=None, help="output run directory")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; fails if CUDA is absent)",
    )
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
    summary = run_experiment(cfg, out, device=args.device)
    print(f"run complete -> {out}")
    for k, v in summary.items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
