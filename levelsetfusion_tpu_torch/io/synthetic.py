"""Synthetic depth data. Twin of ``levelsetfusion_tpu/io/synthetic.py``.

Deterministic numpy generators; cameras come from the port's ``core``. This
slice carries the 3D blob-on-a-wall depth image that the single-pair
experiment uses; the 2D and sequence generators come with their slices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from levelsetfusion_tpu_torch.core.camera import PinholeCamera


def default_camera_3d(width: int = 128, height: int = 128) -> PinholeCamera:
    f = float(width) / 2.0
    return PinholeCamera(
        fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
        image_width=width, image_height=height,
    )


def blob_wall_depth_3d(
    camera: PinholeCamera,
    wall_depth: float = 0.4,
    blob_center_px: Tuple[float, float] | None = None,
    blob_radius_px: float = 24.0,
    blob_height: float = 0.08,
) -> np.ndarray:
    """Depth image of a wall with a radially symmetric smooth blob."""
    h, w = camera.image_height, camera.image_width
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    cu, cv = (
        (w / 2.0, h / 2.0) if blob_center_px is None else blob_center_px
    )
    r = np.sqrt((u - cu) ** 2 + (v - cv) ** 2) / blob_radius_px
    bump = np.where(r < 1.0, blob_height * np.cos(0.5 * np.pi * r) ** 2, 0.0)
    return (wall_depth - bump).astype(np.float32)
