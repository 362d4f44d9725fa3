"""Single-level non-rigid warp solver. Twin of
``levelsetfusion_tpu/models/single_level.py`` (its fused path).

Gradient descent on the warp aligning ``live`` to ``canonical``. Each
iteration is one resample (``ops/kernels/resample.py``) and one fused
gradient/update (``ops/kernels/fused_gradient.py``); the warp is carried
component-major ``(3, X, Y, Z)``, the layout both kernels take. The same
loop runs on every device: the two kernel wrappers launch the CUDA kernels
for CUDA tensors and their plain versions for CPU tensors.

Semantics kept from the JAX twin:

- the loop runs while ``iteration < max_iterations`` and the last
  ``max_update >= convergence_threshold`` (the first iteration always runs);
- with ``adaptive_learning_rate`` the rate halves when the total energy
  exceeds the previous iteration's (the first comparison is against +inf);
- five telemetry buffers of length ``max_iterations``, zero past
  ``iterations``; mean update = Σ‖δu‖ / voxel count;
- ``converged = max_update < convergence_threshold``;
- ``max_abs_displacement`` is the per-axis max |u| over the warm start,
  every updated warp and the final warp.

The rate, the previous energy and the telemetry stay on the device; the host
reads one scalar (``max_update``) per iteration for the loop condition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    from_component_major,
    fused_gradient_update,
    sobolev_taps,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm


class SolveTelemetry(NamedTuple):
    """Per-iteration log: energy components and warp-update statistics;
    entries past ``iterations`` are 0."""

    data_energy: torch.Tensor
    smoothing_energy: torch.Tensor
    level_set_energy: torch.Tensor
    max_warp_update: torch.Tensor
    mean_warp_update: torch.Tensor


class SolveResult(NamedTuple):
    warp: torch.Tensor  # (*spatial, 3)
    iterations: int
    converged: bool
    telemetry: SolveTelemetry
    # Per-axis running max of |u| (voxel units) over every warp the solve
    # resampled with, the warm start included, and the final warp.
    max_abs_displacement: torch.Tensor


def solve_single_level(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    initial_warp: torch.Tensor | None = None,
) -> SolveResult:
    """Optimize the warp aligning ``live`` to ``canonical``.

    Args:
      canonical: scalar TSDF field ``(X, Y, Z)``, float32.
      live: scalar TSDF field, same shape and device.
      params: solver parameters.
      initial_warp: optional warm start ``(X, Y, Z, 3)``, else zeros.
    """
    if canonical.ndim != 3:
        raise NotImplementedError(
            "the 2D single-level solve is not ported yet (ROADMAP A8)"
        )
    device = canonical.device
    if initial_warp is None:
        warp_cm = torch.zeros((3, *canonical.shape), dtype=torch.float32, device=device)
    else:
        warp_cm = to_component_major(initial_warp)
    taps = (
        sobolev_taps(params.sobolev_kernel_size, params.sobolev_strength)
        if params.sobolev_smoothing
        else ()
    )
    n = params.max_iterations
    num_voxels = float(canonical.numel())
    # The JAX twin compares its f32 max_update against the threshold rounded
    # to f32; compare the same way.
    threshold = float(np.float32(params.convergence_threshold))

    telemetry = torch.zeros((5, n), dtype=torch.float32, device=device)
    rate = torch.tensor(params.learning_rate, dtype=torch.float32, device=device)
    prev_energy = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    max_disp = torch.amax(torch.abs(warp_cm), dim=(1, 2, 3))
    max_update = float("inf")
    iteration = 0
    while iteration < n and max_update >= threshold:
        warped = warp_field_cm(live, warp_cm)
        warp_cm, stats = fused_gradient_update(
            warped, canonical, warp_cm, rate,
            w_data=params.data_term_weight,
            w_smooth=params.smoothing_term_weight,
            w_ls=params.level_set_term_weight,
            killing=params.smoothing_mode is SmoothingMode.KILLING,
            gamma=params.rigidity_enforcement_factor,
            band_union=params.band_union_only,
            taps=taps,
        )
        energy = stats[0] + stats[1] + stats[2]
        if params.adaptive_learning_rate:
            rate = torch.where(energy > prev_energy, rate * 0.5, rate)
        prev_energy = energy
        telemetry[:, iteration] = torch.stack(
            [stats[0], stats[1], stats[2], stats[4], stats[3] / num_voxels]
        )
        max_disp = torch.maximum(max_disp, stats[5:8])
        max_update = float(stats[4])
        iteration += 1

    return SolveResult(
        warp=from_component_major(warp_cm),
        iterations=iteration,
        converged=max_update < threshold,
        telemetry=SolveTelemetry(*telemetry),
        max_abs_displacement=torch.maximum(
            max_disp, torch.amax(torch.abs(warp_cm), dim=(1, 2, 3))
        ),
    )
