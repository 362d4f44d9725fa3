"""Multi-resolution pyramids and warp prolongation. Twin of
``levelsetfusion_tpu/ops/pyramid.py``.

The hierarchical solver builds power-of-two pyramids of the canonical and
live TSDF fields (coarse levels by 2× block-mean downsampling; the EWA
alternative regenerates coarse levels from depth, ``models/hierarchical.py``)
and prolongates the solved warp from a coarse level to the next finer one:
multi-linear ×2 upsampling, displacements doubled, since warps are in voxel
units and the voxel size halves.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.utils.profiling import span


def downsample2x_mean(field: torch.Tensor) -> torch.Tensor:
    """2× block-mean downsample of a scalar field (2D or 3D)."""
    d = field.ndim
    if any(s % 2 for s in field.shape):
        raise ValueError(f"shape {tuple(field.shape)} not divisible by 2")
    shape = []
    for s in field.shape:
        shape.extend([s // 2, 2])
    # Mean over the interleaved block axes (1, 3, 5, ...).
    return field.reshape(shape).mean(dim=tuple(range(1, 2 * d, 2)))


def build_pyramid(field: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Pyramid [coarsest, ..., finest] with ``levels`` entries."""
    with span("lsf.pyramid"):
        pyr = [field]
        for _ in range(levels - 1):
            pyr.append(downsample2x_mean(pyr[-1]))
        return pyr[::-1]


def prolongate_warp(warp: torch.Tensor, target_shape=None) -> torch.Tensor:
    """Upsample a warp field ``(*spatial, D)`` to 2× resolution.

    Multi-linear interpolation of each component, values doubled. The JAX
    twin's ``jax.image.resize(..., "linear")`` samples output voxel i at
    input coordinate (i + 0.5) / 2 − 0.5 and, at the edge, drops the tap
    outside the volume and renormalises; ``F.interpolate`` with
    ``align_corners=False`` samples the same coordinate and clamps it to
    the edge, which gives the same value (tests/test_torch_pyramid.py).
    """
    spatial = tuple(warp.shape[:-1])
    if target_shape is None:
        target_shape = tuple(2 * s for s in spatial)
    mode = {2: "bilinear", 3: "trilinear"}[len(spatial)]
    up = F.interpolate(warp.movedim(-1, 0)[None], size=tuple(target_shape), mode=mode,
                       align_corners=False)[0]
    return up.movedim(0, -1) * 2.0
