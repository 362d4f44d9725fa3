"""Hierarchical coarse-to-fine warp solver. Twin of
``levelsetfusion_tpu/models/hierarchical.py``.

Builds power-of-two pyramids of the canonical and live TSDF fields, solves
the warp at the coarsest level, then prolongates it (×2 upsample,
displacement doubled) as the warm start of each finer level. A level's solve
is ``solve_single_level``'s (``models/single_level.py``), in ``loop_for``'s
kept loop of the level's shape: on CUDA a captured graph, kept one a level,
so a caller that solves many pairs (the fusion's frames) captures each
level's graph once.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from levelsetfusion_tpu_torch.models.params import HierarchicalParams
from levelsetfusion_tpu_torch.models.single_level import SolveResult, solve_single_level
from levelsetfusion_tpu_torch.ops import pyramid
from levelsetfusion_tpu_torch.ops.tsdf import (
    GenerationMethod,
    generate_tsdf_2d,
    generate_tsdf_3d,
)
from levelsetfusion_tpu_torch.utils.profiling import span


class HierarchicalResult(NamedTuple):
    warp: torch.Tensor  # finest-level warp
    level_results: List[SolveResult]  # [coarsest, ..., finest]
    # Sharded solves only (parallel/hierarchical.py): each level's live halo,
    # an int for a level that ran sharded, None for one that ran replicated
    # (no halo contract). None on single-device solves.
    level_halos: tuple | None = None


def build_pyramid_from_depth(
    depth: torch.Tensor,
    camera,
    grid,
    levels: int,
    narrow_band_width_voxels: int = 20,
    coarse_method: GenerationMethod | None = None,
):
    """EWA-aware pyramid: instead of block-mean downsampling the fine TSDF,
    each coarse level is generated from the depth image on a coarsened grid
    with EWA sampling (the coarse voxel's image footprint is integrated, not
    aliased). Returns ([coarsest, ..., finest] fields, matching GridSpecs)."""
    if coarse_method is None:
        coarse_method = GenerationMethod.EWA_IMAGE
    gen = generate_tsdf_2d if grid.dim == 2 else generate_tsdf_3d
    fields, grids = [], []
    g = grid
    with span("lsf.pyramid"):
        for level in range(levels):
            method = GenerationMethod.BASIC if level == 0 else coarse_method
            fields.append(gen(depth, camera, g,
                              narrow_band_width_voxels=narrow_band_width_voxels, method=method))
            grids.append(g)
            if level + 1 < levels:
                # Halve the band width in voxels as voxels double in size, so
                # the metric truncation distance is kept across levels.
                narrow_band_width_voxels = max(narrow_band_width_voxels // 2, 2)
                g = g.coarsened(2)
    return fields[::-1], grids[::-1]


def downsample_warp(warp: torch.Tensor, times: int) -> torch.Tensor:
    """A warp ``(*spatial, D)`` ``times`` levels coarser: block mean per
    component, displacement halved each level."""
    for _ in range(times):
        warp = torch.stack(
            [pyramid.downsample2x_mean(warp[..., c]) for c in range(warp.shape[-1])], dim=-1
        ) * 0.5
    return warp


def solve_hierarchical(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: HierarchicalParams = HierarchicalParams(),
    initial_warp: torch.Tensor | None = None,
) -> HierarchicalResult:
    """Coarse-to-fine warp solve on the fields' device.

    ``initial_warp`` (finest resolution) is downsampled to the coarsest level
    if given, as warm-started multi-frame fusion does.
    """
    canon_pyr = pyramid.build_pyramid(canonical, params.levels)
    live_pyr = pyramid.build_pyramid(live, params.levels)
    warp = None
    if initial_warp is not None:
        warp = downsample_warp(initial_warp, params.levels - 1)
    return _solve_over_pyramids(canon_pyr, live_pyr, params, warp)


def _solve_over_pyramids(canon_pyr, live_pyr, params: HierarchicalParams,
                         warp=None) -> HierarchicalResult:
    """Solve each level from the prolongated warp of the one before."""
    results: List[SolveResult] = []
    for level in range(params.levels):
        canon_l, live_l = canon_pyr[level], live_pyr[level]
        res = solve_single_level(canon_l, live_l, params.base, warp)
        results.append(res)
        if level + 1 < params.levels:
            with span("lsf.prolongate"):
                warp = pyramid.prolongate_warp(res.warp,
                                               target_shape=canon_pyr[level + 1].shape)
        else:
            warp = res.warp
    return HierarchicalResult(warp=warp, level_results=results)


def solve_hierarchical_from_depth(
    canonical_depth: torch.Tensor,
    live_depth: torch.Tensor,
    camera,
    grid,
    params: HierarchicalParams = HierarchicalParams(),
    narrow_band_width_voxels: int = 20,
    coarse_method: GenerationMethod | None = None,
) -> HierarchicalResult:
    """Hierarchical solve on pyramids regenerated from depth with EWA."""
    canon_pyr, _ = build_pyramid_from_depth(
        canonical_depth, camera, grid, params.levels, narrow_band_width_voxels, coarse_method)
    live_pyr, _ = build_pyramid_from_depth(
        live_depth, camera, grid, params.levels, narrow_band_width_voxels, coarse_method)
    return _solve_over_pyramids(canon_pyr, live_pyr, params)
