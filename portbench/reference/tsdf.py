"""TSDF generation, BASIC (nearest pixel), by the definition:

- voxel centre ``p = (offset + index) * voxel_size`` in world metres, the
  camera at the origin looking down +z (identity extrinsic);
- ``u = fx x / z + cx``, ``v = fy y / z + cy``, rounded half to even to the
  nearest pixel;
- ``tsdf = clip((depth - z) / (nb / 2 * voxel_size), -1, 1)`` where the
  voxel is in front of the camera (z > 1e-4), projects into the image and
  sees a depth > 0; +1 elsewhere.

Computed in x-slabs so a 512³ volume's temporaries stay small.
"""

from __future__ import annotations

import torch

NEAR = 1e-4
SLAB_VOXELS = 1 << 23  # voxels a slab of the temporaries holds


def generate(depth: torch.Tensor, cam, shape, voxel_size: float, offset,
             band_voxels: int, dtype=torch.float32) -> torch.Tensor:
    """The TSDF of ``depth`` ((H, W) metres on the target device) over the
    grid ``shape`` / ``voxel_size`` / ``offset``; ``cam`` has fx, fy, cx,
    cy, width, height."""
    dev = depth.device
    depth = depth.to(dtype)
    band = 0.5 * band_voxels * voxel_size
    X, Y, Z = shape
    slab = max(1, SLAB_VOXELS // (Y * Z))
    out = torch.empty(shape, dtype=dtype, device=dev)
    ys = ((torch.arange(Y, dtype=dtype, device=dev) + offset[1]) * voxel_size).view(1, Y, 1)
    zs = ((torch.arange(Z, dtype=dtype, device=dev) + offset[2]) * voxel_size).view(1, 1, Z)
    for x0 in range(0, X, slab):
        x1 = min(X, x0 + slab)
        xs = ((torch.arange(x0, x1, dtype=dtype, device=dev) + offset[0])
              * voxel_size).view(-1, 1, 1)
        x, y, z = torch.broadcast_tensors(xs, ys, zs)
        front = z > NEAR
        zz = torch.where(front, z, torch.ones_like(z))
        u = torch.round(cam.fx * x / zz + cam.cx).long()
        v = torch.round(cam.fy * y / zz + cam.cy).long()
        seen = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        d = depth[v.clamp(0, cam.height - 1), u.clamp(0, cam.width - 1)]
        valid = front & seen & (d > 0)
        value = torch.clamp((d - z) / band, -1.0, 1.0)
        out[x0:x1] = torch.where(valid, value, torch.ones_like(value))
    return out
