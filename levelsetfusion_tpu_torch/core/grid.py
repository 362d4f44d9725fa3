"""Voxel grid specification and coordinate helpers.

Twin of ``levelsetfusion_tpu/core/grid.py``; the conventions are the same:

- A field is a tensor of shape ``(*spatial,)`` (scalar TSDF) or
  ``(*spatial, D)`` (vector field, e.g. a warp), float32.
- Spatial rank ``D`` is 2 or 3; array axis ``d`` maps to world axis ``d``:
  ``world[d] = (offset[d] + index[d]) * voxel_size``. In 3D axis 2 is the
  camera depth ``z`` and the contiguous axis.
- Warps store displacements in voxel units along the array axes.
- TSDF values are truncated to [-1, 1]; unobserved voxels hold +1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a regular voxel grid.

    Attributes:
      shape: spatial extents, length 2 or 3.
      voxel_size: edge length of one voxel in meters.
      offset: voxel offset of array index (0,...,0) from the world origin;
        world position of voxel ``idx`` is ``(offset + idx) * voxel_size``.
    """

    shape: Tuple[int, ...]
    voxel_size: float = 0.004
    offset: Tuple[int, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.offset is None:
            object.__setattr__(self, "offset", (0,) * len(self.shape))
        if len(self.offset) != len(self.shape):
            raise ValueError(
                f"offset rank {len(self.offset)} != shape rank {len(self.shape)}"
            )
        if len(self.shape) not in (2, 3):
            raise ValueError(f"only 2D/3D grids supported, got shape {self.shape}")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.shape))

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray(self.offset, np.float32) * self.voxel_size
        hi = (np.asarray(self.offset, np.float32) + np.asarray(self.shape) - 1) * (
            self.voxel_size
        )
        return lo, hi

    def with_shape(self, shape: Tuple[int, ...]) -> "GridSpec":
        return dataclasses.replace(self, shape=tuple(shape))

    def coarsened(self, factor: int = 2) -> "GridSpec":
        """Grid covering the same region at ``factor``-times coarser
        resolution (shape divided, voxel size multiplied, world extents
        preserved)."""
        if any(s % factor for s in self.shape):
            raise ValueError(f"shape {self.shape} not divisible by {factor}")
        return GridSpec(
            shape=tuple(s // factor for s in self.shape),
            voxel_size=self.voxel_size * factor,
            offset=tuple((o + (factor - 1) / 2.0) / factor for o in self.offset),
        )


def voxel_center_coordinates(
    grid: GridSpec, device: torch.device | str, dtype=torch.float32
) -> torch.Tensor:
    """World coordinates of every voxel center, shape ``(*grid.shape, D)``."""
    axes = [
        (torch.arange(n, dtype=dtype, device=device) + o) * grid.voxel_size
        for n, o in zip(grid.shape, grid.offset)
    ]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
