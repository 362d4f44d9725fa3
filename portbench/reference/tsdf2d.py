"""The 2D TSDF of one depth scanline, BASIC (nearest pixel), by the
definition:

- voxel centre ``p = (offset + index) * voxel_size`` in world metres on the
  x–z plane, the camera at the origin looking down +z (identity extrinsic);
- ``u = fx x / z + cx``, rounded half to even to the nearest pixel;
- ``tsdf = clip((depth - z) / (nb / 2 * voxel_size), -1, 1)`` where the
  voxel is in front of the camera (z > 1e-4), projects into the scanline and
  sees a depth > 0; +1 elsewhere.
"""

from __future__ import annotations

import torch

NEAR = 1e-4


def generate(depth: torch.Tensor, cam, shape, voxel_size: float, offset, band_voxels: int,
             dtype=torch.float32) -> torch.Tensor:
    """The TSDF of ``depth`` ((W,) metres on the target device) over the
    (X, Z) grid ``shape`` / ``voxel_size`` / ``offset``; ``cam`` has fx, cx
    and width."""
    dev = depth.device
    depth = depth.to(dtype)
    band = 0.5 * band_voxels * voxel_size
    X, Z = shape
    x = ((torch.arange(X, dtype=dtype, device=dev) + offset[0]) * voxel_size).view(X, 1)
    z = ((torch.arange(Z, dtype=dtype, device=dev) + offset[1]) * voxel_size).view(1, Z)
    x, z = torch.broadcast_tensors(x, z)
    front = z > NEAR
    u = torch.round(cam.fx * x / torch.where(front, z, torch.ones_like(z)) + cam.cx).long()
    seen = (u >= 0) & (u < cam.width)
    d = depth[u.clamp(0, cam.width - 1)]
    value = torch.clamp((d - z) / band, -1.0, 1.0)
    return torch.where(front & seen & (d > 0), value, torch.ones_like(value))
