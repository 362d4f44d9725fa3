"""Distributed warp solve over 2D voxel blocks: spatial axes 0 and 1 split
over a 2D mesh. Twin of ``levelsetfusion_tpu/parallel/sharded2d.py``, its
fused path.

``solve_single_level_sharded2d`` is ``parallel.sharded``'s sync solver
with its halos along both mesh axes (``parallel.mesh.Mesh2D``):

- The **live** field is exchanged once per solve with a halo of
  ``live_halo`` slices along axis 0, then axis 1 (``exchange_2d``: the
  corners come from the diagonal neighbour), +1 beyond the global edges.
- The **canonical** field is exchanged once with ``stencil_halo`` slices
  along both axes (from two or more ranks away where a block is thinner
  than that).
- An iteration: the warp's ``stencil_halo`` ghost rows go out first, then
  its ghost columns; B1 resamples the block's interior from the haloed live
  block (``x_start`` for the rows; along y the warp is zero-padded over the
  live halo's columns, the whole y-extended block resampled and the
  interior columns kept, so B1 needs no y window); the warped field's ghost
  shells come from the neighbours (rows, then columns); one B2 call updates
  the block on its x and y windows, the face rules firing at the volume's
  global edges only.
- Termination rounds of k iterations, one reduction of each kind over both
  axes a round, one host read a round, and the telemetry reduced once after
  the loop: ``parallel.sharded.sync_rounds``.

The live-halo contract holds along both axes: every displacement within
``live_halo - 2`` of a block's face (``utils/debug.py``,
``sharded_axes=(0, 1)``). ``warp_field_sharded2d`` is the fusion blend's
gather on the same blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import SolveResult, fused_step_kwargs
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.parallel.halo import exchange_2d, halo_exchange
from levelsetfusion_tpu_torch.parallel.mesh import Mesh2D
from levelsetfusion_tpu_torch.parallel.sharded import initial_warp_cm, sync_rounds


def resample_block_2d(live_ext: torch.Tensor, warp_cm: torch.Tensor, x_start: int,
                      y_start: int) -> torch.Tensor:
    """B1 on a 2D block: output voxel (i, j, k) samples ``live_ext`` at
    ``(x_start + i + ux, y_start + j + uy, k + uz)``, where ``live_ext``
    holds ``y_start`` columns more than the warp on each side. The warp is
    zero-padded over those columns, the whole y-extended block resampled
    through B1's ``x_start``, and the warp's columns kept (the padded
    columns are redundant work)."""
    ny = warp_cm.shape[2]
    if live_ext.shape[1] != ny + 2 * y_start:
        raise ValueError(f"live block of {live_ext.shape[1]} columns for a warp of {ny} and "
                         f"y_start {y_start}")
    wk = F.pad(warp_cm, (0, 0, y_start, y_start)) if y_start else warp_cm
    return warp_field_cm(live_ext, wk, x_start=x_start).narrow(1, y_start, ny).contiguous()


def _check_blocks(canonical: torch.Tensor, mesh: Mesh2D, min_halo: int) -> tuple:
    if canonical.ndim != 3:
        raise ValueError("2D-mesh block sharding applies to 3D volumes; 2D experiments "
                         "fit one device (use the 1D sharded solver if needed)")
    n0, n1 = canonical.shape[:2]
    if n0 < min_halo or n1 < min_halo:
        raise ValueError(f"local block {n0}x{n1} too small for stencil halos")
    return n0, n1


def solve_single_level_sharded2d(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh2D,
    live_halo: int = 8,
    initial_warp: torch.Tensor | None = None,
) -> SolveResult:
    """2D voxel-block twin of ``solve_single_level`` (see the module
    docstring).

    Args:
      canonical, live: the rank's blocks ``(n0, n1, Z)`` of the scalar
        fields, float32, on ``mesh.device``; every rank's the same shape.
      initial_warp: the rank's block of the warm start ``(n0, n1, Z, 3)``.

    Returns the rank's block of the warp; ``iterations``, ``converged``,
    the telemetry and the per-axis max |u| are the volume's.
    """
    hx = params.stencil_halo
    n0, n1 = _check_blocks(canonical, mesh, 3 if params.sobolev_smoothing else 2)
    ax0, ax1 = mesh.axes
    lh = min(live_halo, n0, n1)  # neighbour-only halos: one block at most
    kw = fused_step_kwargs(params)
    window = dict(x_offset=ax0.index * n0 - hx, x_global=n0 * ax0.size, x_lo=hx, x_len=n0,
                  y_offset=ax1.index * n1 - hx, y_global=n1 * ax1.size, y_lo=hx, y_len=n1)
    live_ext = exchange_2d(live, lh, mesh, fill="truncation")
    canon_ext = exchange_2d(canonical, hx, mesh, fill="truncation")

    def step(warp, rate):
        # The warp's ghost rows first, then its ghost columns.
        pending = halo_exchange(warp, hx, ax0, fill="replicate", axis=1, wait=False)
        warped = resample_block_2d(live_ext, warp, lh, lh)
        warp_ext = halo_exchange(pending.wait(), hx, ax1, fill="replicate", axis=2)
        warped_ext = exchange_2d(warped, hx, mesh, fill="truncation")
        return fused_gradient_update(warped_ext, canon_ext, warp_ext, rate, **kw, **window)

    return sync_rounds(step, initial_warp_cm(canonical, initial_warp), params, mesh,
                       float(canonical.numel() * mesh.world))


def warp_field_sharded2d(live: torch.Tensor, warp: torch.Tensor, mesh: Mesh2D,
                         live_halo: int = 8) -> torch.Tensor:
    """Resample the rank's 2D block of ``live`` at ``v + warp(v)`` with one
    two-axis halo exchange of ``min(live_halo, n0, n1)`` slices (+1 beyond
    the global edges; the corners from the diagonal neighbours): the fusion
    blend's gather. ``warp`` is the rank's block ``(n0, n1, Z, 3)``;
    displacements beyond the halo read +1."""
    lh = min(live_halo, *live.shape[:2])
    live_ext = exchange_2d(live, lh, mesh, fill="truncation")
    return resample_block_2d(live_ext, to_component_major(warp), lh, lh)
