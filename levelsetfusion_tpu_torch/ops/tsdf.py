"""TSDF generation from depth images. Twin of ``levelsetfusion_tpu/ops/tsdf.py``.

Depth image → truncated signed distance field on a regular voxel grid, 2D
(one camera scanline → an x–z planar field) and 3D, by one of four methods:

- ``BASIC``              — point-sample the depth image at the voxel's
                           projection (nearest pixel).
- ``EWA_IMAGE``          — elliptical-weighted average of *depth* samples in
                           a Gaussian footprint of the voxel projected into
                           the image (for coarse grids).
- ``EWA_TSDF``           — EWA of per-sample *TSDF* values, invalid samples
                           excluded.
- ``EWA_TSDF_INCLUSIVE`` — EWA of per-sample TSDF values, invalid samples
                           contributing the truncation value (+1).

Conventions (the JAX package's, pinned by its tests and by
tests/test_torch_core.py):

- depths are meters, ``<= 0`` marks an invalid measurement;
- signed distance = (measured depth − voxel camera-space depth), scaled by
  the half band width ``(narrow_band_width_voxels / 2) * voxel_size`` and
  clipped to [-1, 1];
- voxels that are out of view, behind the camera, or see an invalid depth
  get +1.0.

Plain torch on the image's device, as the reference is XLA: the EWA window
is a static loop of 7 taps (2D) or 7×7 (3D) over every voxel.
"""

from __future__ import annotations

import enum

import torch

from levelsetfusion_tpu_torch.core.camera import Camera2d, PinholeCamera, transform_points
from levelsetfusion_tpu_torch.core.grid import GridSpec, voxel_center_coordinates
from levelsetfusion_tpu_torch.utils.profiling import span


class GenerationMethod(enum.Enum):
    BASIC = "basic"
    EWA_IMAGE = "ewa_image"
    EWA_TSDF = "ewa_tsdf"
    EWA_TSDF_INCLUSIVE = "ewa_tsdf_inclusive"


NEAR_CLIP = 1e-4
# Static half-width (in pixels) of the EWA gather window.
EWA_WINDOW_RADIUS = 3
# Screen-space antialiasing variance added to the projected voxel footprint.
EWA_SCREEN_VARIANCE = 0.25


def _finalize(sdf_scaled: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, torch.clamp(sdf_scaled, -1.0, 1.0), 1.0)


class _Ewa:
    """The three running sums of an EWA window, tap by tap."""

    def __init__(self, method: GenerationMethod, z: torch.Tensor, band: float):
        self.method, self.z, self.band = method, z, band
        self.num = torch.zeros_like(z)
        self.weight = torch.zeros_like(z)
        self.full_weight = torch.zeros_like(z)

    def add(self, w: torch.Tensor, depth: torch.Tensor, dvalid: torch.Tensor) -> None:
        wv = torch.where(dvalid, w, 0.0)
        self.full_weight = self.full_weight + w
        self.weight = self.weight + wv
        if self.method is GenerationMethod.EWA_IMAGE:
            self.num = self.num + wv * depth
            return
        tsdf_k = torch.clamp((depth - self.z) / self.band, -1.0, 1.0)
        if self.method is GenerationMethod.EWA_TSDF_INCLUSIVE:
            self.num = self.num + w * torch.where(dvalid, tsdf_k, 1.0)
        else:
            self.num = self.num + wv * tsdf_k

    def result(self, in_front: torch.Tensor) -> torch.Tensor:
        any_valid = self.weight > 0.0
        if self.method is GenerationMethod.EWA_IMAGE:
            depth_avg = self.num / torch.clamp(self.weight, min=1e-12)
            return _finalize((depth_avg - self.z) / self.band, in_front & any_valid)
        if self.method is GenerationMethod.EWA_TSDF:
            tsdf = self.num / torch.clamp(self.weight, min=1e-12)
            return torch.where(in_front & any_valid, torch.clamp(tsdf, -1.0, 1.0), 1.0)
        # EWA_TSDF_INCLUSIVE: normalised by the full window weight.
        tsdf = self.num / torch.clamp(self.full_weight, min=1e-12)
        return torch.where(in_front, torch.clamp(tsdf, -1.0, 1.0), 1.0)


def generate_tsdf_2d(
    depth_row: torch.Tensor,
    camera: Camera2d,
    grid: GridSpec,
    extrinsic: torch.Tensor | None = None,
    narrow_band_width_voxels: int = 20,
    method: GenerationMethod = GenerationMethod.BASIC,
) -> torch.Tensor:
    """Generate a 2D x–z planar TSDF field from one depth scanline, on the
    scanline's device.

    Args:
      depth_row: ``(image_width,)`` depths in meters, <=0 invalid.
      camera: scanline camera intrinsics.
      grid: 2D grid spec (axis 0 = x, axis 1 = z).
      extrinsic: optional 3x3 homogeneous camera-from-world transform.
    """
    with span("lsf.tsdf"):
        return _tsdf_2d(depth_row, camera, grid, extrinsic, narrow_band_width_voxels, method)


def _tsdf_2d(depth_row, camera, grid, extrinsic, narrow_band_width_voxels, method):
    if grid.dim != 2:
        raise ValueError(f"generate_tsdf_2d needs a 2D grid, got {grid.shape}")
    band = 0.5 * narrow_band_width_voxels * grid.voxel_size
    points = voxel_center_coordinates(grid, depth_row.device)  # (X, Z, 2)
    if extrinsic is not None:
        points = transform_points(extrinsic, points)
    x, z = points[..., 0], points[..., 1]
    in_front = z > NEAR_CLIP
    z_safe = torch.where(in_front, z, 1.0)
    u = camera.fx * x / z_safe + camera.cx  # fractional pixel coordinate

    def sample_depth(px):
        inb = (px >= 0) & (px < camera.image_width)
        d = depth_row[torch.clamp(px, 0, camera.image_width - 1)]
        return d, inb & (d > 0.0)

    # torch.round, like jnp.round, rounds half to even.
    center = torch.round(u).to(torch.int64)
    if method is GenerationMethod.BASIC:
        depth, dvalid = sample_depth(center)
        return _finalize((depth - z) / band, in_front & dvalid)

    # The voxel's Gaussian footprint in the image: du/dx = fx/z and a voxel
    # sigma of voxel_size/2, plus the screen antialiasing variance.
    var_u = (camera.fx / z_safe) ** 2 * (0.5 * grid.voxel_size) ** 2 + EWA_SCREEN_VARIANCE
    acc = _Ewa(method, z, band)
    for k in range(-EWA_WINDOW_RADIUS, EWA_WINDOW_RADIUS + 1):
        px = center + k
        w = torch.exp(-0.5 * (px.to(torch.float32) - u) ** 2 / var_u)
        acc.add(w, *sample_depth(px))
    return acc.result(in_front)


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
    with span("lsf.tsdf"):
        return _tsdf_3d(depth_image, camera, grid, extrinsic, narrow_band_width_voxels,
                        method)


def _tsdf_3d(depth_image, camera, grid, extrinsic, narrow_band_width_voxels, method):
    if grid.dim != 3:
        raise ValueError(f"generate_tsdf_3d needs a 3D grid, got {grid.shape}")
    band = 0.5 * narrow_band_width_voxels * grid.voxel_size
    points = voxel_center_coordinates(grid, depth_image.device)  # (X, Y, Z, 3)
    if extrinsic is not None:
        points = transform_points(extrinsic, points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    in_front = z > NEAR_CLIP
    z_safe = torch.where(in_front, z, 1.0)
    u = camera.fx * x / z_safe + camera.cx
    v = camera.fy * y / z_safe + camera.cy

    def sample_depth(pu, pv):
        inb = (
            (pu >= 0)
            & (pu < camera.image_width)
            & (pv >= 0)
            & (pv < camera.image_height)
        )
        d = depth_image[
            torch.clamp(pv, 0, camera.image_height - 1),
            torch.clamp(pu, 0, camera.image_width - 1),
        ]
        return d, inb & (d > 0.0)

    cu = torch.round(u).to(torch.int64)
    cv = torch.round(v).to(torch.int64)
    if method is GenerationMethod.BASIC:
        depth, dvalid = sample_depth(cu, cv)
        return _finalize((depth - z) / band, in_front & dvalid)

    # The projected 2x2 covariance J Σ_voxel Jᵀ + antialias I, with
    # Σ_voxel = (vs/2)² I₃ and J = [[fx/z, 0, -fx x/z²], [0, fy/z, -fy y/z²]],
    # and its inverse.
    svox = (0.5 * grid.voxel_size) ** 2
    j00 = camera.fx / z_safe
    j02 = -camera.fx * x / z_safe**2
    j11 = camera.fy / z_safe
    j12 = -camera.fy * y / z_safe**2
    c00 = svox * (j00 * j00 + j02 * j02) + EWA_SCREEN_VARIANCE
    c01 = svox * (j02 * j12)
    c11 = svox * (j11 * j11 + j12 * j12) + EWA_SCREEN_VARIANCE
    det = c00 * c11 - c01 * c01
    i00 = c11 / det
    i01 = -c01 / det
    i11 = c00 / det

    r = EWA_WINDOW_RADIUS
    acc = _Ewa(method, z, band)
    for du in range(-r, r + 1):
        for dv in range(-r, r + 1):
            pu = cu + du
            pv = cv + dv
            eu = pu.to(torch.float32) - u
            ev = pv.to(torch.float32) - v
            w = torch.exp(-0.5 * (i00 * eu * eu + 2.0 * i01 * eu * ev + i11 * ev * ev))
            acc.add(w, *sample_depth(pu, pv))
    return acc.result(in_front)
