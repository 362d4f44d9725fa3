"""Distributed warp solve with block-local inner iterations and a
Schur-complement-style reduction of the interface unknowns. Twin of
``levelsetfusion_tpu/parallel/schur.py``, its fused path.

The volume is split into contiguous blocks along axis 0, one per rank of a
``parallel.mesh.Group``. One **outer step** (see the JAX module for the
derivation):

1. One warp halo exchange: 2 ghost rows a side, frozen through the sweep
   (replicated beyond the global edges, where B2 never reads them).
2. ``T`` inner iterations with no collective: B1 resamples the block and
   its 2 ghost rows from the live block with its halo (``x_start =
   live_halo - 2``), then one B2 call updates the block's rows
   (``x_lo = 2``) with the Sobolev x pass block-local (``conv_local_x``).
3. The interface reduction: each rank exchanges its edge rows' last
   directions with its neighbours (one exchange) and solves the per-cut
   2x2 system ``(I + a A2) delta = d`` in closed form,
   ``delta_own = ((1 + 2a) d_own + a d_nbr) / ((1 + 2a)^2 - a^2)`` with
   ``a = rate w_smooth kappa_c`` (``kappa_c`` 1 for Tikhonov, ``(1 +
   gamma) + [c == 0]`` for Killing), redundantly on both sides; the edge
   rows' last explicit update is replaced by ``delta``. The global x edges
   keep the explicit update.
4. One reduction of each kind (a sum of the energies and sum |delta u|, a
   max of |delta u|) and one host read: the convergence test on the global
   max update of the step's last direction.

The telemetry is per outer step: the last inner iteration's energies and
the corrected direction's update statistics. ``max_abs_displacement`` is the
running per-axis max |u| of every warp the sweeps resampled with and
produced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.models.single_level import fused_step_kwargs
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    from_component_major,
    fused_gradient_update,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.parallel.halo import halo_exchange, pmax_axis, psum_axis
from levelsetfusion_tpu_torch.parallel.mesh import Group, line
from levelsetfusion_tpu_torch.parallel.sharded import initial_warp_cm


class SchurTelemetry(NamedTuple):
    """Per-OUTER-step log (entries past ``outer_steps`` are 0)."""

    data_energy: torch.Tensor
    smoothing_energy: torch.Tensor
    level_set_energy: torch.Tensor
    max_warp_update: torch.Tensor
    mean_warp_update: torch.Tensor


class SchurResult(NamedTuple):
    warp: torch.Tensor  # the rank's block (*spatial, 3)
    outer_steps: int
    inner_per_outer: int
    converged: bool
    telemetry: SchurTelemetry
    # Per-axis running max |u| over every warp the sweeps resampled with or
    # produced, reduced over the ranks: the displacement-contract observable.
    max_abs_displacement: torch.Tensor

    @property
    def iterations(self) -> int:
        """Telemetry rows are per outer step (the logger's and CLI's count)."""
        return self.outer_steps


def interface_reduce(warp: torch.Tensor, direction: torch.Tensor, rate: torch.Tensor,
                     params: SolverParams, axis) -> tuple:
    """Step 3 along ``axis`` (a ``Group`` or a ``MeshAxis``) on the
    component-major block: the edge rows' directions exchanged with the
    neighbours, the closed-form 2x2 solve, and the edge rows' last update
    replaced by delta (the explicit one at a global edge). Returns the
    corrected ``(warp, direction)``."""
    ax = line(axis)
    d_first, d_last = direction[:, :1], direction[:, -1:]
    if ax.size > 1:
        # [the previous rank's last row, ..., the next rank's first row].
        ext = halo_exchange(direction, 1, axis, fill="zero", axis=1)
        nbr_last, nbr_first = ext[:, :1], ext[:, -1:]
    else:
        nbr_last, nbr_first = d_last, d_first
    # kappa_c: the smoothing operator's coupling across an axis-0 cut
    # (Killing's grad div adds d_xx on component 0).
    kappa = [1.0] * 3
    if params.smoothing_mode is SmoothingMode.KILLING:
        gamma = params.rigidity_enforcement_factor
        kappa = [(1.0 + gamma) + (1.0 if c == 0 else 0.0) for c in range(3)]
    kappa = torch.tensor(kappa, device=warp.device).view(3, 1, 1, 1)
    a = rate * params.smoothing_term_weight * kappa
    det = (1.0 + 2.0 * a) ** 2 - a * a

    def solve2(own, nbr):
        return ((1.0 + 2.0 * a) * own + a * nbr) / det

    delta_first = d_first if ax.index == 0 else solve2(d_first, nbr_last)
    delta_last = d_last if ax.index == ax.size - 1 else solve2(d_last, nbr_first)
    warp, direction = warp.clone(), direction.clone()
    warp[:, :1] += delta_first - d_first
    warp[:, -1:] += delta_last - d_last
    direction[:, :1] = delta_first
    direction[:, -1:] = delta_last
    return warp, direction


def outer_reduce(direction: torch.Tensor, energies: torch.Tensor, group) -> tuple:
    """Step 4 over ``group``: ``(sums [e_data, e_smooth, e_ls, sum |delta
    u|], max |delta u|)``, one sum and one max."""
    ulen = torch.sqrt(torch.sum(direction * direction, dim=0))
    sums = psum_axis(torch.cat([energies, torch.sum(ulen).view(1)]), group)
    return sums, pmax_axis(torch.max(ulen), group)


def schur_outer_loop(sweep, warp: torch.Tensor, params: SolverParams, inner_iterations: int,
                     interface_axis, group, num_voxels: float) -> SchurResult:
    """The Schur solvers' outer loop: ``sweep(warp, rate, max_disp)`` runs
    one step's inner iterations and returns ``(warp, last direction, last
    stats, max_disp)``; then the interface reduction along
    ``interface_axis`` and the reductions over ``group``, one host read a
    step."""
    device = warp.device
    n_outer = -(-params.max_iterations // inner_iterations)
    threshold = float(np.float32(params.convergence_threshold))
    spatial = tuple(range(1, warp.ndim))
    tel = torch.zeros((5, n_outer), dtype=torch.float32, device=device)
    rate = torch.tensor(params.learning_rate, dtype=torch.float32, device=device)
    prev_energy = torch.tensor(float("inf"), device=device)
    max_disp = torch.zeros(3, dtype=torch.float32, device=device)
    s, max_up = 0, float("inf")
    while s < n_outer and max_up >= threshold:
        warp, direction, stats, max_disp = sweep(warp, rate, max_disp)
        warp, direction = interface_reduce(warp, direction, rate, params, interface_axis)
        sums, max_up_dev = outer_reduce(direction, stats[:3], group)
        energy = sums[0] + sums[1] + sums[2]
        if params.adaptive_learning_rate:
            rate = torch.where(energy > prev_energy, rate * 0.5, rate)
        prev_energy = energy
        tel[:, s] = torch.stack([sums[0], sums[1], sums[2], max_up_dev,
                                 sums[3] / num_voxels])
        s += 1
        max_up = float(max_up_dev)
    max_disp = pmax_axis(torch.maximum(max_disp, torch.amax(torch.abs(warp), dim=spatial)),
                         group)
    return SchurResult(
        warp=from_component_major(warp),
        outer_steps=s,
        inner_per_outer=inner_iterations,
        converged=bool(max_up < threshold),
        telemetry=SchurTelemetry(*tel),
        max_abs_displacement=max_disp,
    )


def edge_padded(field: torch.Tensor, rows: int = 2) -> torch.Tensor:
    """``field`` with ``rows`` copies of its edge rows a side: the Schur
    kernels' canonical, whose ghost rows B2 never reads (``conv_local_x``,
    and the energies count the window only), so no exchange."""
    n = field.shape[0]
    return torch.cat([field[:1].expand(rows, *field.shape[1:]), field,
                      field[n - 1:].expand(rows, *field.shape[1:])]).contiguous()


def solve_single_level_schur(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    *,
    group: Group,
    live_halo: int = 8,
    inner_iterations: int = 8,
    initial_warp: torch.Tensor | None = None,
) -> SchurResult:
    """Schur twin of ``solve_single_level_sharded`` (see the module
    docstring) on the rank's blocks ``(n, Y, Z)``.

    ``params.max_iterations`` is the total inner-iteration budget: at most
    ``ceil(max_iterations / inner_iterations)`` outer steps, ending once the
    global max update of a step's corrected last direction is below the
    threshold. An adaptive rate adapts once an outer step, on the reduced
    energy.
    """
    if canonical.ndim != 3:
        raise ValueError("the Schur solver runs 3D volumes")
    n_local = canonical.shape[0]
    ax = line(group)
    live_halo = min(live_halo, n_local)
    min_halo = 3 if params.sobolev_smoothing else 2
    if n_local < min_halo:
        raise ValueError(f"local block of {n_local} rows too small for stencil halos")
    kw = fused_step_kwargs(params)
    window = dict(x_offset=ax.index * n_local - 2, x_global=n_local * ax.size, x_lo=2,
                  x_len=n_local, conv_local_x=True)
    live_ext = halo_exchange(live, live_halo, group, fill="truncation")
    canon_ext = edge_padded(canonical)

    def sweep(warp, rate, max_disp):
        # (1) the frozen ghost rows; (2) the inner iterations.
        warp_ext = halo_exchange(warp, 2, group, fill="replicate", axis=1)
        ghosts = (warp_ext[:, :2], warp_ext[:, -2:])
        max_disp = torch.maximum(max_disp, torch.amax(torch.abs(warp), dim=(1, 2, 3)))
        for _ in range(inner_iterations):
            w_ext = torch.cat([ghosts[0], warp, ghosts[1]], dim=1)
            warped = warp_field_cm(live_ext, w_ext, x_start=live_halo - 2)
            new_warp, stats = fused_gradient_update(warped, canon_ext, w_ext, rate, **kw,
                                                    **window)
            max_disp = torch.maximum(max_disp, stats[5:])
            direction, warp = new_warp - warp, new_warp
        return warp, direction, stats, max_disp

    return schur_outer_loop(sweep, initial_warp_cm(canonical, initial_warp), params,
                            inner_iterations, group, group,
                            float(canonical.numel() * ax.size))
