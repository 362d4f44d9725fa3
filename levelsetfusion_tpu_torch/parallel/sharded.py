"""Distributed warp solve over voxel-block shards (config5). Twin of
``levelsetfusion_tpu/parallel/sharded.py``, its fused path.

``solve_single_level_sharded`` solves ``models.single_level``'s problem
with the volume split into contiguous blocks along spatial axis 0, one per
rank of a ``parallel.mesh.Group``; each rank passes its own blocks and gets
its own block of the warp back.

- The **live** field is exchanged once per solve with a halo of
  ``live_halo`` rows (+1 beyond the global edges; at most one block): the
  resample reads the haloed copy, so it is exact while every axis-0
  displacement stays within ``live_halo - 2`` rows of a block's face.
- The **canonical** field is exchanged once with ``stencil_halo`` rows
  (from two or more ranks away where a block is thinner than that).
- An iteration is JAX's overlapped fused step: the warp's ``stencil_halo``
  ghost rows (3 components, replicated at the global edges) are sent first
  and waited for only before B2; B1 (``ops/kernels/resample.py``, with
  ``x_start``) resamples the block's own rows from the haloed live block;
  the warped field's ``stencil_halo`` rows are exchanged; then B2
  (``ops/kernels/fused_gradient.py``) updates the block on its x window,
  the face rules firing only at the volume's global edges. A 2D volume runs
  B1 and the plain version of that windowed step, as the single-device 2D
  loop does.
- **Termination rounds** (JAX's ``termination_check_interval`` k): the loop
  runs rounds of k iterations with no collective inside a round. After a
  round, one ``pmax`` of its last iteration's max update, and the host
  reads it once: the solve goes on while fewer than ``n_iter`` iterations
  ran and it is at least the threshold. With the adaptive rate, one
  ``psum`` of the round's last energy, compared with the previous round's,
  halves the rate. ``n_iter`` is ``max_iterations`` rounded up to a
  multiple of k, so up to k - 1 iterations may run past the gate. Each
  iteration's telemetry is recorded locally and reduced once after the loop
  (sums, max, sum over the voxel count). At k = 1 this is the
  single-device semantics; at k > 1 the trajectory is JAX's sharded one:
  the extra iterations update the warp and the rate halves at most once a
  round, where the single-device loop (``models/single_level.py``) freezes
  at the gate whatever its host-read interval.

The loop runs eagerly, with one host read a round. The live halo contract
is the caller's to check (``utils/debug.py::check_displacement_contract``).
"""

from __future__ import annotations

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import (
    SolveResult,
    SolveTelemetry,
    fused_step_kwargs,
)
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    from_component_major,
    fused_gradient_update,
    fused_gradient_update_reference,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.parallel.halo import halo_exchange, pmax_axis, psum_axis
from levelsetfusion_tpu_torch.parallel.mesh import Group
from levelsetfusion_tpu_torch.utils.profiling import span

# Telemetry rows from B2's stats (data, smoothing and level-set energies,
# sum and max of ‖δu‖): data, smoothing, level set, max, sum (the mean
# after the reduction).
_TEL_ROWS = (0, 1, 2, 4, 3)


def warp_field_sharded(live: torch.Tensor, warp: torch.Tensor, group: Group,
                       live_halo: int = 8) -> torch.Tensor:
    """Resample the rank's block of ``live`` at ``v + warp(v)`` with one
    halo exchange of ``min(live_halo, block rows)`` rows (+1 beyond the
    global edges): the fusion step's gather. ``warp`` is the rank's block,
    ``(n, ..., D)``; axis-0 displacements beyond the halo read +1."""
    lh = min(live_halo, live.shape[0])
    live_ext = halo_exchange(live, lh, group, fill="truncation")
    return warp_field_cm(live_ext, to_component_major(warp), x_start=lh)


def solve_single_level_sharded(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    *,
    group: Group,
    live_halo: int = 8,
    initial_warp: torch.Tensor | None = None,
) -> SolveResult:
    """Sharded twin of ``solve_single_level`` (see the module docstring).

    Args:
      canonical, live: the rank's blocks ``(n, Y, Z)`` or ``(n, Z)`` of the
        scalar fields, float32, on ``group.device``; every rank's ``n`` is
        the same.
      initial_warp: the rank's block of the warm start ``(n, ..., D)``.

    Returns the rank's block of the warp; ``iterations``, ``converged``,
    the telemetry (length ``n_iter``) and the per-axis max |u| are the
    volume's, the same on every rank.
    """
    n_local = canonical.shape[0]
    x_global = n_local * group.world
    live_halo = min(live_halo, n_local)  # neighbour-only halos: one block at most
    hx = params.stencil_halo
    if n_local < (3 if params.sobolev_smoothing else 2):
        raise ValueError(f"local block of {n_local} rows too small for stencil halos")
    kw = fused_step_kwargs(params)
    window = dict(x_offset=group.rank * n_local - hx, x_global=x_global, x_lo=hx,
                  x_len=n_local)
    fused = fused_gradient_update if canonical.ndim == 3 else fused_gradient_update_reference
    live_ext = halo_exchange(live, live_halo, group, fill="truncation")
    canon_ext = halo_exchange(canonical, hx, group, fill="truncation")

    def step(warp, rate):
        # The warp's ghost rows first; nothing waits for them until B2.
        pending = halo_exchange(warp, hx, group, fill="replicate", axis=1, wait=False)
        warped = warp_field_cm(live_ext, warp, x_start=live_halo)
        warped_ext = halo_exchange(warped, hx, group, fill="truncation")
        return fused(warped_ext, canon_ext, pending.wait(), rate, **kw, **window)

    return sync_rounds(step, initial_warp_cm(canonical, initial_warp), params, group,
                       float(x_global * np.prod(canonical.shape[1:])))


def initial_warp_cm(canonical: torch.Tensor, initial_warp: torch.Tensor | None):
    """The component-major warm start (zeros without one)."""
    if initial_warp is None:
        return torch.zeros((canonical.ndim, *canonical.shape), dtype=canonical.dtype,
                           device=canonical.device)
    return to_component_major(initial_warp)


def sync_rounds(step, warp: torch.Tensor, params: SolverParams, group,
                num_voxels: float) -> SolveResult:
    """The sync solvers' loop (see the module docstring): ``step(warp,
    rate)`` gives the next component-major warp block and its 5 + D stats
    (B2's), in rounds of k iterations with one reduction of each kind over
    ``group`` (a ``Group`` or a ``Mesh2D``'s both axes) and one host read a
    round, the telemetry reduced once after the loop."""
    with span("lsf.solve"):
        return _rounds(step, warp, params, group, num_voxels)


def _rounds(step, warp, params, group, num_voxels) -> SolveResult:
    device = warp.device
    k = max(1, params.termination_check_interval)
    n_iter = -(-params.max_iterations // k) * k
    threshold = float(np.float32(params.convergence_threshold))
    spatial = tuple(range(1, warp.ndim))
    max_disp = torch.amax(torch.abs(warp), dim=spatial)
    tel = torch.zeros((5, n_iter), dtype=torch.float32, device=device)
    rows = torch.tensor(_TEL_ROWS, device=device)
    rate = torch.tensor(params.learning_rate, dtype=torch.float32, device=device)
    prev_energy = torch.tensor(float("inf"), device=device)
    it, max_up = 0, float("inf")

    while it < n_iter and max_up >= threshold:
        for _ in range(k):
            warp, stats = step(warp, rate)
            tel[:, it] = stats.index_select(0, rows)
            max_disp = torch.maximum(max_disp, stats[5:])
            it += 1
        # The round's one reduction of each kind and one host read.
        max_up_dev = pmax_axis(stats[4], group)
        if params.adaptive_learning_rate:
            energy = psum_axis(stats[0] + stats[1] + stats[2], group)
            rate = torch.where(energy > prev_energy, rate * 0.5, rate)
            prev_energy = energy
        with span("lsf.solve.flag_read"):
            max_up = float(max_up_dev)

    max_disp = pmax_axis(torch.maximum(max_disp, torch.amax(torch.abs(warp), dim=spatial)),
                         group)
    sums = psum_axis(tel[[0, 1, 2, 4]], group)
    telemetry = SolveTelemetry(sums[0], sums[1], sums[2], pmax_axis(tel[3], group),
                               sums[3] / num_voxels)
    return SolveResult(
        warp=from_component_major(warp),
        iterations=it,
        converged=bool(max_up < threshold),
        telemetry=telemetry,
        max_abs_displacement=max_disp,
    )
