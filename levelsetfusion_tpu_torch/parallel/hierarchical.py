"""Sharded hierarchical (coarse-to-fine) warp solve. Twin of
``levelsetfusion_tpu/parallel/hierarchical.py``.

The sharded solvers' live-halo contract (every displacement within
``live_halo - 2`` slices of a block's face) is kept by construction:

- **Coarse levels run replicated.** Every rank solves them whole, with the
  single-device semantics (``models/single_level.py::solve_single_level``,
  in ``loop_for``'s kept loop of the level's shape, on CUDA a captured
  graph).
- **Fine levels run sharded** (``parallel/sharded.py`` on a ``Group``,
  ``parallel/sharded2d.py`` on a ``Mesh2D``), warm-started by the
  prolongated coarser warp, with a live halo sized from that warp's
  measured max |u| along the sharded axes (one host read a level, reduced
  over the ranks so that all take the same path) plus ``halo_margin``, at
  least ``min_live_halo``. A level whose blocks are too thin for its
  stencils, or for that halo, runs replicated.

Every rank holds the whole fields: the pyramids and the prolongation run on
whole volumes (a sharded level's warp is gathered after its solve), as the
JAX twin's glue runs on global arrays. The result's warp and level results
are whole volumes on every rank.
"""

from __future__ import annotations

import math
from typing import List

import torch

from levelsetfusion_tpu_torch.models.hierarchical import HierarchicalResult, downsample_warp
from levelsetfusion_tpu_torch.models.params import HierarchicalParams
from levelsetfusion_tpu_torch.models.single_level import SolveResult, solve_single_level
from levelsetfusion_tpu_torch.ops import pyramid
from levelsetfusion_tpu_torch.parallel.halo import pmax_axis
from levelsetfusion_tpu_torch.parallel.mesh import Group, Mesh2D, gather_field, shard_field
from levelsetfusion_tpu_torch.parallel.sharded import solve_single_level_sharded
from levelsetfusion_tpu_torch.parallel.sharded2d import solve_single_level_sharded2d


def _max_displacement_rows(warp: torch.Tensor, axes, group) -> float:
    """Max |u| over the sharded axes' components, voxels, the same on every
    rank."""
    md = torch.amax(torch.abs(warp[..., list(axes)]))
    return float(pmax_axis(md, group))


def _level_can_shard(shape, n_devices: int, min_rows: int) -> bool:
    return shape[0] % n_devices == 0 and shape[0] // n_devices >= min_rows


def _level_can_shard2d(shape, nd0: int, nd1: int, min_rows: int) -> bool:
    return (shape[0] % nd0 == 0 and shape[0] // nd0 >= min_rows
            and shape[1] % nd1 == 0 and shape[1] // nd1 >= min_rows)


def solve_hierarchical_sharded(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: HierarchicalParams = HierarchicalParams(),
    *,
    group: Group | Mesh2D,
    initial_warp: torch.Tensor | None = None,
    min_live_halo: int = 8,
    halo_margin: int = 2,
    pyramids=None,
) -> HierarchicalResult:
    """Coarse-to-fine solve of the whole fields ``canonical``/``live`` (every
    rank passes them, on the group's device), its fine levels split over
    ``group``: along axis 0 on a ``Group``, along axes 0 and 1 on a
    ``Mesh2D``.

    Args:
      initial_warp: optional finest-level warm start (multi-frame fusion).
      min_live_halo: floor of the sharded levels' live halo.
      halo_margin: halo slices beyond the measured coarse displacement (the
        fine level's own updates).
      pyramids: optional ``(canon_pyr, live_pyr)``, coarsest first (e.g.
        ``models.hierarchical.build_pyramid_from_depth``'s EWA levels);
        default 2x block means of the fields.

    Returns the finest warp, each level's result (whole volumes) and each
    level's live halo (None where it ran replicated).
    """
    two_d = isinstance(group, Mesh2D)
    disp_axes = (0, 1) if two_d else (0,)
    min_rows = 3 if params.base.sobolev_smoothing else 2
    if pyramids is not None:
        canon_pyr, live_pyr = pyramids
    else:
        canon_pyr = pyramid.build_pyramid(canonical, params.levels)
        live_pyr = pyramid.build_pyramid(live, params.levels)
    warp = None
    if initial_warp is not None:
        warp = downsample_warp(initial_warp, params.levels - 1)

    results: List[SolveResult] = []
    level_halos: List[int | None] = []
    for level in range(params.levels):
        canon_l, live_l = canon_pyr[level], live_pyr[level]
        shape = tuple(canon_l.shape)
        need = 0
        if warp is not None:
            need = int(math.ceil(_max_displacement_rows(warp, disp_axes, group))) + 2
        live_halo = max(min_live_halo, need + halo_margin)
        if two_d:
            nd0, nd1 = group.shape
            n_local = min(shape[0] // nd0 if shape[0] % nd0 == 0 else 0,
                          shape[1] // nd1 if shape[1] % nd1 == 0 else 0)
            use_shard = _level_can_shard2d(shape, nd0, nd1, min_rows) and live_halo <= n_local
        else:
            n_local = shape[0] // group.world if shape[0] % group.world == 0 else 0
            use_shard = _level_can_shard(shape, group.world, min_rows) and live_halo <= n_local
        level_halos.append(live_halo if use_shard else None)
        if use_shard:
            solve = solve_single_level_sharded2d if two_d else solve_single_level_sharded
            kw = {"mesh": group} if two_d else {"group": group}
            res = solve(shard_field(canon_l, group), shard_field(live_l, group), params.base,
                        live_halo=live_halo,
                        initial_warp=None if warp is None else shard_field(warp, group), **kw)
            res = res._replace(warp=gather_field(res.warp, group))
        else:
            # Too small to shard, or the motion exceeds a one-block halo:
            # this level replicated, with the single-device semantics.
            res = solve_single_level(canon_l, live_l, params.base, warp)
        results.append(res)
        if level + 1 < params.levels:
            warp = pyramid.prolongate_warp(res.warp, target_shape=canon_pyr[level + 1].shape)
        else:
            warp = res.warp
    return HierarchicalResult(warp=warp, level_results=results,
                              level_halos=tuple(level_halos))
