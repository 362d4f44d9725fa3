"""Synthetic depth data. Twin of ``levelsetfusion_tpu/io/synthetic.py``.

Deterministic numpy generators; cameras come from the port's ``core``: the
2D bump-on-a-wall scanline pair (configs 1–2 and ``rigid_2d``), the 3D
blob-on-a-wall depth image and pair of the single-pair experiment, and the
snoopy-style sequence of the fusion experiment (config4).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from levelsetfusion_tpu_torch.core.camera import Camera2d, PinholeCamera


class DepthPair2d(NamedTuple):
    canonical_depth: np.ndarray  # (W,) meters
    live_depth: np.ndarray  # (W,) meters
    camera: Camera2d


class DepthSequence3d(NamedTuple):
    frames: List[np.ndarray]  # each (H, W) meters
    camera: PinholeCamera


def default_camera_2d(width: int = 128) -> Camera2d:
    # Wide-fov scanline camera: view extent ±0.8z around the axis.
    return Camera2d(fx=float(width) / 2.0, cx=width / 2.0, image_width=width)


def default_camera_3d(width: int = 128, height: int = 128) -> PinholeCamera:
    f = float(width) / 2.0
    return PinholeCamera(
        fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
        image_width=width, image_height=height,
    )


def _bump(x: np.ndarray, center: float, radius: float, height: float) -> np.ndarray:
    """Smooth C¹ bump: height * cos²(π/2 · d/radius) inside |d| < radius."""
    d = (x - center) / radius
    return np.where(np.abs(d) < 1.0, height * np.cos(0.5 * np.pi * d) ** 2, 0.0)


def bump_wall_pair_2d(
    width: int = 128,
    wall_depth: float = 0.4,
    bump_height: float = 0.08,
    bump_radius_px: float = 20.0,
    bump_center_px: float | None = None,
    live_shift_px: float = 6.0,
    live_height_scale: float = 1.0,
) -> DepthPair2d:
    """Canonical: bump at ``bump_center_px``; live: bump shifted/scaled (a
    smooth lateral warp near the bump, zero far away)."""
    cam = default_camera_2d(width)
    x = np.arange(width, dtype=np.float32)
    c = width / 2.0 if bump_center_px is None else bump_center_px
    canonical = wall_depth - _bump(x, c, bump_radius_px, bump_height)
    live = wall_depth - _bump(
        x, c + live_shift_px, bump_radius_px, bump_height * live_height_scale
    )
    return DepthPair2d(
        canonical.astype(np.float32), live.astype(np.float32), cam
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


def blob_pair_3d(
    width: int = 64,
    height: int = 64,
    live_shift_px: Tuple[float, float] = (5.0, 0.0),
    live_height_scale: float = 1.0,
    **kw,
):
    cam = default_camera_3d(width, height)
    canonical = blob_wall_depth_3d(cam, **kw)
    cu, cv = width / 2.0 + live_shift_px[0], height / 2.0 + live_shift_px[1]
    live = blob_wall_depth_3d(
        cam,
        blob_center_px=(cu, cv),
        blob_height=kw.get("blob_height", 0.08) * live_height_scale,
        **{k: v for k, v in kw.items() if k != "blob_height"},
    )
    return canonical, live, cam


def snoopy_style_sequence_3d(
    num_frames: int = 8,
    width: int = 64,
    height: int = 64,
    wall_depth: float = 0.4,
    blob_radius_px: float = 18.0,
    blob_height: float = 0.07,
    drift_px_per_frame: Tuple[float, float] = (2.0, 1.0),
    pulse_amplitude: float = 0.15,
) -> DepthSequence3d:
    """A deforming blob drifting across the image over ``num_frames`` frames.

    Mimics the shape of the KillingFusion Snoopy workload: per-frame depth
    images of a non-rigidly deforming object observed by a fixed camera.
    """
    cam = default_camera_3d(width, height)
    frames = []
    for t in range(num_frames):
        cu = width / 2.0 + drift_px_per_frame[0] * t
        cv = height / 2.0 + drift_px_per_frame[1] * t
        scale = 1.0 + pulse_amplitude * np.sin(2 * np.pi * t / max(num_frames - 1, 1))
        frames.append(
            blob_wall_depth_3d(
                cam,
                wall_depth=wall_depth,
                blob_center_px=(cu, cv),
                blob_radius_px=blob_radius_px * scale,
                blob_height=blob_height,
            )
        )
    return DepthSequence3d(frames=frames, camera=cam)
