"""Camera models. Twin of ``levelsetfusion_tpu/core/camera.py``.

Extrinsics are homogeneous camera-from-world matrices (3x3 for 2D, 4x4 for
3D), passed separately.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera2d:
    """1D-image pinhole camera for x–z planar (scanline) experiments."""

    fx: float
    cx: float
    image_width: int

    def project(self, points_xz: torch.Tensor) -> torch.Tensor:
        """(..., 2) camera-space (x, z) points -> (...,) pixel u coordinates."""
        x, z = points_xz[..., 0], points_xz[..., 1]
        return self.fx * x / z + self.cx


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Standard pinhole depth camera (3D), depths in meters."""

    fx: float
    fy: float
    cx: float
    cy: float
    image_width: int
    image_height: int

    def project(self, points_xyz: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-space points -> (..., 2) pixel (u, v) coordinates."""
        x, y, z = points_xyz[..., 0], points_xyz[..., 1], points_xyz[..., 2]
        u = self.fx * x / z + self.cx
        v = self.fy * y / z + self.cy
        return torch.stack([u, v], dim=-1)

    def scanline(self) -> Camera2d:
        """The x–z planar camera of this camera's central scanline."""
        return Camera2d(fx=self.fx, cx=self.cx, image_width=self.image_width)


def identity_extrinsic(dim: int, device="cpu") -> torch.Tensor:
    """Homogeneous identity camera-from-world matrix (3x3 for 2D, 4x4 for 3D)."""
    return torch.eye(dim + 1, dtype=torch.float32, device=device)


def se2_matrix(angle: float, tx: float, tz: float) -> np.ndarray:
    """Homogeneous 3x3 rigid transform in the x–z plane."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[c, -s, tx], [s, c, tz], [0.0, 0.0, 1.0]], dtype=np.float32
    )


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a homogeneous (D+1)x(D+1) transform to (..., D) points.

    Runs at full f32: the package turns TF32 off on import (see
    ``levelsetfusion_tpu_torch/__init__.py`` for why).
    """
    d = points.shape[-1]
    return torch.matmul(points, matrix[:d, :d].T) + matrix[:d, d]
