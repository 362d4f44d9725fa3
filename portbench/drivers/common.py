"""What the drivers share: the program's configuration and camera from a
cell's files, both sides' TSDFs of a depth image, and the gaps the
comparison reads."""

from __future__ import annotations

import dataclasses

import torch

from levelsetfusion_tpu_torch.core.camera import PinholeCamera
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_3d
from levelsetfusion_tpu_torch.utils.config import ExperimentConfig

from portbench.lib import traffic as gen
from portbench.reference import tsdf as ref_tsdf


def program_config(config: dict) -> ExperimentConfig:
    """The program's ``ExperimentConfig`` of a configuration file (its keys
    that the program's configuration has)."""
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig.from_dict({k: v for k, v in config.items() if k in fields})


def grid(cfg: ExperimentConfig) -> GridSpec:
    return GridSpec(shape=tuple(cfg.grid_shape), voxel_size=cfg.voxel_size,
                    offset=tuple(cfg.grid_offset))


def program_camera(mix: dict) -> PinholeCamera:
    c = gen.camera(mix["camera"])
    return PinholeCamera(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, image_width=c.width,
                         image_height=c.height)


def program_tsdf(run, state, depth) -> torch.Tensor:
    """The program's TSDF of a depth image (metres) on the state's grid and
    camera, as its configuration generates it."""
    return generate_tsdf_3d(
        torch.from_numpy(depth).to(run.device), state.camera, state.grid,
        narrow_band_width_voxels=state.cfg.narrow_band_width_voxels,
        method=state.cfg.generation_method)


def reference_tsdf(run, depth, dtype=torch.float32) -> torch.Tensor:
    """The plain reference's TSDF of a depth image (metres), in ``dtype``,
    from the cell's configuration and the traffic's camera."""
    config = run.cell.config
    return ref_tsdf.generate(torch.from_numpy(depth).to(run.device),
                             gen.camera(run.cell.traffic["camera"]), config["grid_shape"],
                             config["voxel_size"], config["grid_offset"],
                             config["narrow_band_width_voxels"], dtype)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    """Return the program's freed blocks to the card before the reference
    runs."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest |a - b| (float32)."""
    return float(torch.max(torch.abs(a.float() - b.float())))


# A TSDF value (in [-1, 1]) that differs by more than this differs.
FIELD_TOL = 1e-3


def mismatch(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """The share of voxels where |a - b| > ``tol``."""
    return float(torch.count_nonzero(torch.abs(a.float() - b.float()) > tol)) / a.numel()


def worst(rows) -> list:
    """[(name, the largest value of that name over ``rows``)], ``rows``
    being dicts of the same names."""
    return [(name, max(r[name] for r in rows)) for name in rows[0]]
