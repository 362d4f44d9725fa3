"""Warp-energy gradient assembly. Twin of ``levelsetfusion_tpu/ops/gradient.py``.

One function computes the combined descent direction

    g = w_data * ∇E_data + w_smooth * ∇E_smooth + w_ls * ∇E_ls
    (optionally Sobolev-filtered)

and the weighted term energies, from ``(canonical, live, warp)``
(``warp_energy_gradient``) or, where the warped live field is already
resampled, from ``(canonical, warped, warp)`` (``energy_gradient``, which
the 2D step's plain version runs after its resample). This is the
plain-torch assembly; on CUDA the solve loop runs the same math through the
kernels of ``ops/kernels/fused_gradient.py`` (3D) and
``ops/kernels/step2d.py`` (2D).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from levelsetfusion_tpu_torch.ops import derivatives, interpolation, sobolev, terms


class SmoothingMode(enum.Enum):
    TIKHONOV = "tikhonov"
    KILLING = "killing"


class EnergyBreakdown(NamedTuple):
    data: torch.Tensor
    smoothing: torch.Tensor
    level_set: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.data + self.smoothing + self.level_set


class GradientResult(NamedTuple):
    gradient: torch.Tensor  # (*spatial, D) combined (possibly filtered) descent dir
    energies: EnergyBreakdown
    warped_live: torch.Tensor


def warp_energy_gradient(
    canonical: torch.Tensor,
    live: torch.Tensor,
    warp: torch.Tensor,
    data_term_weight: float = 1.0,
    smoothing_term_weight: float = 0.2,
    level_set_term_weight: float = 0.0,
    smoothing_mode: SmoothingMode = SmoothingMode.TIKHONOV,
    rigidity_enforcement_factor: float = 0.1,
    band_union_only: bool = True,
    sobolev_kernel: torch.Tensor | None = None,
) -> GradientResult:
    """Combined energy gradient at the current warp ``(*spatial, D)``."""
    return energy_gradient(
        canonical, interpolation.warp_field(live, warp), warp,
        data_term_weight, smoothing_term_weight, level_set_term_weight,
        smoothing_mode, rigidity_enforcement_factor, band_union_only, sobolev_kernel,
    )


def energy_gradient(
    canonical: torch.Tensor,
    warped: torch.Tensor,
    warp: torch.Tensor,
    data_term_weight: float = 1.0,
    smoothing_term_weight: float = 0.2,
    level_set_term_weight: float = 0.0,
    smoothing_mode: SmoothingMode = SmoothingMode.TIKHONOV,
    rigidity_enforcement_factor: float = 0.1,
    band_union_only: bool = True,
    sobolev_kernel: torch.Tensor | None = None,
) -> GradientResult:
    """``warp_energy_gradient`` from ``warped``, the live field already
    resampled at ``v + warp(v)``. Reads nothing back to the host, so it may
    run inside a CUDA graph capture (with ``sobolev_kernel`` a tensor on
    the fields' device)."""
    warped_grad = derivatives.gradient(warped)
    zero = torch.zeros((), dtype=canonical.dtype, device=canonical.device)

    g_data, e_data = terms.data_term(
        warped, canonical, warped_grad, band_union_only=band_union_only
    )
    total = data_term_weight * g_data
    e_data = data_term_weight * e_data

    e_smooth = zero
    if smoothing_term_weight != 0.0:
        if smoothing_mode is SmoothingMode.TIKHONOV:
            g_smooth, e_smooth = terms.tikhonov_term(warp)
        else:
            g_smooth, e_smooth = terms.killing_term(
                warp, rigidity_enforcement_factor
            )
        total = total + smoothing_term_weight * g_smooth
        e_smooth = smoothing_term_weight * e_smooth

    e_ls = zero
    if level_set_term_weight != 0.0:
        g_ls, e_ls = terms.level_set_term(
            warped, warped_grad, canonical, band_union_only=band_union_only
        )
        total = total + level_set_term_weight * g_ls
        e_ls = level_set_term_weight * e_ls

    if sobolev_kernel is not None:
        total = sobolev.convolve_with_sobolev_kernel(
            total, sobolev_kernel, num_spatial_dims=warp.ndim - 1
        )

    return GradientResult(
        gradient=total,
        energies=EnergyBreakdown(e_data, e_smooth, e_ls),
        warped_live=warped,
    )
