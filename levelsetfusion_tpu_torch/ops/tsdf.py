"""TSDF generation from depth images. Twin of ``levelsetfusion_tpu/ops/tsdf.py``.

Conventions (the JAX package's, pinned by its tests and by
tests/test_torch_core.py):

- depths are meters, ``<= 0`` marks an invalid measurement;
- signed distance = (measured depth − voxel camera-space depth), scaled by
  the half band width ``(narrow_band_width_voxels / 2) * voxel_size`` and
  clipped to [-1, 1];
- voxels that are out of view, behind the camera, or see an invalid depth
  get +1.0.

This slice ports the BASIC method (nearest-pixel point sample). The EWA
methods raise until they are ported.
"""

from __future__ import annotations

import enum

import torch

from levelsetfusion_tpu_torch.core.camera import PinholeCamera, transform_points
from levelsetfusion_tpu_torch.core.grid import GridSpec, voxel_center_coordinates


class GenerationMethod(enum.Enum):
    BASIC = "basic"
    EWA_IMAGE = "ewa_image"
    EWA_TSDF = "ewa_tsdf"
    EWA_TSDF_INCLUSIVE = "ewa_tsdf_inclusive"


NEAR_CLIP = 1e-4


def _finalize(sdf_scaled: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, torch.clamp(sdf_scaled, -1.0, 1.0), 1.0)


def generate_tsdf_3d(
    depth_image: torch.Tensor,
    camera: PinholeCamera,
    grid: GridSpec,
    extrinsic: torch.Tensor | None = None,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> torch.Tensor:
    """Generate a 3D TSDF volume from a depth image, on the image's device.

    Args:
      depth_image: ``(image_height, image_width)`` depths in meters, <=0 invalid.
      grid: 3D grid spec (axes = x, y, z; z is the camera depth axis for the
        identity extrinsic).
    """
    if grid.dim != 3:
        raise ValueError(f"generate_tsdf_3d needs a 3D grid, got {grid.shape}")
    if method is not GenerationMethod.BASIC:
        raise NotImplementedError(
            f"TSDF method {method.value} is not ported yet (ROADMAP A6)"
        )
    band = 0.5 * narrow_band_width_voxels * grid.voxel_size
    points = voxel_center_coordinates(grid, depth_image.device)  # (X, Y, Z, 3)
    if extrinsic is not None:
        points = transform_points(extrinsic, points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    in_front = z > NEAR_CLIP
    z_safe = torch.where(in_front, z, 1.0)
    u = camera.fx * x / z_safe + camera.cx
    v = camera.fy * y / z_safe + camera.cy

    # torch.round, like jnp.round, rounds half to even.
    pu = torch.round(u).to(torch.int64)
    pv = torch.round(v).to(torch.int64)
    inb = (
        (pu >= 0)
        & (pu < camera.image_width)
        & (pv >= 0)
        & (pv < camera.image_height)
    )
    depth = depth_image[
        torch.clamp(pv, 0, camera.image_height - 1),
        torch.clamp(pu, 0, camera.image_width - 1),
    ]
    dvalid = inb & (depth > 0.0)
    sdf = (depth - z) / band
    return _finalize(sdf, in_front & dvalid)
