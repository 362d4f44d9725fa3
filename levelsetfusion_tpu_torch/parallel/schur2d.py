"""Schur-outer x sync-inner warp solve on a 2D mesh. Twin of
``levelsetfusion_tpu/parallel/schur2d.py``, its fused path.

The volume splits over both spatial axes 0 and 1 (``parallel.mesh.Mesh2D``,
as ``parallel/sharded2d.py``). Mesh axis 0 runs ``parallel/schur.py``'s
outer structure, mesh axis 1 the sync structure. One outer step:

1. One axis-0 warp exchange: 2 frozen ghost rows a side.
2. ``T`` inner iterations: the block with its frozen ghost rows exchanges
   ``stencil_halo`` live ghost columns along axis 1 (one axis-1 exchange an
   iteration, so the corners come from the axis-1 neighbours' frozen rows);
   B1 resamples that whole (n0 + 4, n1 + 2 stencil_halo) window from the
   live block with its two-axis halo (``x_start`` for the rows, the warp
   zero-padded over the remaining live-halo columns); one B2 call updates
   the block on its x window under ``conv_local_x`` (the Schur 2-ghost-row
   contract) and its y window (the sync y face rules and zero-padded y
   filter at the global columns only).
3. The axis-0 interface reduction of ``parallel/schur.py`` per column and
   component, one axis-0 exchange.
4. One reduction of each kind over both axes and one host read.

The telemetry is per outer step, as ``parallel/schur.py``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import fused_step_kwargs
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import fused_gradient_update
from levelsetfusion_tpu_torch.parallel.halo import exchange_2d, halo_exchange
from levelsetfusion_tpu_torch.parallel.mesh import Mesh2D
from levelsetfusion_tpu_torch.parallel.schur import SchurResult, edge_padded, schur_outer_loop
from levelsetfusion_tpu_torch.parallel.sharded import initial_warp_cm
from levelsetfusion_tpu_torch.parallel.sharded2d import _check_blocks, resample_block_2d


def solve_single_level_schur2d(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    *,
    mesh: Mesh2D,
    live_halo: int = 8,
    inner_iterations: int = 8,
    initial_warp: torch.Tensor | None = None,
) -> SchurResult:
    """Schur-outer (mesh axis 0) x sync-inner (mesh axis 1) solve on the
    rank's blocks ``(n0, n1, Z)`` (see the module docstring).

    ``params.max_iterations`` is the total inner-iteration budget, as
    ``solve_single_level_schur``'s; an adaptive rate adapts once an outer
    step on the energy reduced over both axes.
    """
    n0, n1 = _check_blocks(canonical, mesh, 3 if params.sobolev_smoothing else 2)
    ax0, ax1 = mesh.axes
    lh = min(live_halo, n0, n1)
    hy = params.stencil_halo
    kw = fused_step_kwargs(params)
    window = dict(x_offset=ax0.index * n0 - 2, x_global=n0 * ax0.size, x_lo=2, x_len=n0,
                  y_offset=ax1.index * n1 - hy, y_global=n1 * ax1.size, y_lo=hy, y_len=n1,
                  conv_local_x=True)
    live_ext = exchange_2d(live, lh, mesh, fill="truncation")
    if lh < hy:
        # The warp's ghost columns reach past the live halo: +1 there, as a
        # gather past the halo reads.
        live_ext = F.pad(live_ext, (0, 0, hy - lh, hy - lh), value=1.0)
    y_start = max(lh, hy) - hy
    canon_ext = halo_exchange(edge_padded(canonical), hy, ax1, fill="truncation", axis=1)

    def sweep(warp, rate, max_disp):
        # (1) one axis-0 round: the frozen ghost rows; (2) the inner
        # iterations, one axis-1 round each.
        warp_x = halo_exchange(warp, 2, ax0, fill="replicate", axis=1)
        ghosts = (warp_x[:, :2], warp_x[:, -2:])
        max_disp = torch.maximum(max_disp, torch.amax(torch.abs(warp), dim=(1, 2, 3)))
        for _ in range(inner_iterations):
            w_x = torch.cat([ghosts[0], warp, ghosts[1]], dim=1)
            w_ext = halo_exchange(w_x, hy, ax1, fill="replicate", axis=2)
            warped = resample_block_2d(live_ext, w_ext, lh - 2, y_start)
            new_warp, stats = fused_gradient_update(warped, canon_ext, w_ext, rate, **kw,
                                                    **window)
            max_disp = torch.maximum(max_disp, stats[5:])
            direction, warp = new_warp - warp, new_warp
        return warp, direction, stats, max_disp

    return schur_outer_loop(sweep, initial_warp_cm(canonical, initial_warp), params,
                            inner_iterations, ax0, mesh, float(canonical.numel() * mesh.world))
