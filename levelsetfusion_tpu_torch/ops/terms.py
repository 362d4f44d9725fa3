"""Energy terms and their gradients. Twin of ``levelsetfusion_tpu/ops/terms.py``.

Each term returns ``(gradient_field, energy)``; ``gradient_field`` has shape
``(*spatial, D)``, ``energy`` is a 0-d tensor. All in voxel units.

    data:      E = ½ Σ (Φ_w − Φ_c)²,        ∇E = (Φ_w − Φ_c) ∇Φ_w
    Tikhonov:  E = ½ Σ ‖J u‖²_F,            ∇E = −Δu
    Killing:   E = ½ Σ (½‖J+Jᵀ‖² + γ‖J‖²),  ∇E = −(1+γ)Δu − ∇(∇·u)
    level set: E = ½ Σ (‖∇Φ_w‖ − 1)²,
               ∇E = (‖∇Φ_w‖ − 1)/(‖∇Φ_w‖ + ε) · H(Φ_w) ∇Φ_w

With ``band_union_only`` the data and level-set terms vanish where both the
canonical and the warped live field are at truncation (|Φ| ≥ 1 − 1e-5).
The JAX twin's docstrings carry the derivations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from levelsetfusion_tpu_torch.ops import derivatives

TRUNCATION_EPS = 1e-5


def band_union_mask(
    canonical: torch.Tensor, warped_live: torch.Tensor
) -> torch.Tensor:
    """True where at least one field is inside the narrow band (|Φ| < 1)."""
    return (torch.abs(canonical) < 1.0 - TRUNCATION_EPS) | (
        torch.abs(warped_live) < 1.0 - TRUNCATION_EPS
    )


def data_term(
    warped_live: torch.Tensor,
    canonical: torch.Tensor,
    warped_live_gradient: torch.Tensor,
    band_union_only: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-term gradient and energy."""
    diff = _data_difference(warped_live, canonical, band_union_only)
    return diff[..., None] * warped_live_gradient, 0.5 * torch.sum(diff * diff)


def _data_difference(warped_live, canonical, band_union_only):
    diff = warped_live - canonical
    if band_union_only:
        diff = torch.where(band_union_mask(canonical, warped_live), diff, 0.0)
    return diff


def data_energy(
    warped_live: torch.Tensor, canonical: torch.Tensor, band_union_only: bool = True
) -> torch.Tensor:
    """The data term's energy alone (of any rows of the fields)."""
    diff = _data_difference(warped_live, canonical, band_union_only)
    return 0.5 * torch.sum(diff * diff)


def tikhonov_term(warp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tikhonov smoothing gradient ``-Δu`` and energy ``½Σ‖Ju‖²``."""
    d = warp.ndim - 1
    grad = -derivatives.laplacian(warp, num_spatial_dims=d)
    return grad, tikhonov_energy(derivatives.vector_jacobian(warp))


def tikhonov_energy(jac: torch.Tensor) -> torch.Tensor:
    """``½Σ‖Ju‖²`` from the warp's Jacobian (of any rows)."""
    return 0.5 * torch.sum(jac * jac)


def killing_term(
    warp: torch.Tensor, rigidity_enforcement_factor: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped approximately-Killing smoothing term: gradient
    ``-(1+γ)Δu - ∇(∇·u)``, energy ``½Σ(½‖J+Jᵀ‖² + γ‖J‖²)``."""
    d = warp.ndim - 1
    gamma = rigidity_enforcement_factor
    lap = derivatives.laplacian(warp, num_spatial_dims=d)
    gdiv = derivatives.gradient_of_divergence(warp)
    grad = -(1.0 + gamma) * lap - gdiv
    return grad, killing_energy(derivatives.vector_jacobian(warp), gamma)


def killing_energy(jac: torch.Tensor, rigidity_enforcement_factor: float = 0.1) -> torch.Tensor:
    """``½Σ(½‖J+Jᵀ‖² + γ‖J‖²)`` from the warp's Jacobian (of any rows)."""
    sym = jac + jac.transpose(-1, -2)
    return 0.5 * (0.5 * torch.sum(sym * sym)
                  + rigidity_enforcement_factor * torch.sum(jac * jac))


def level_set_term(
    warped_live: torch.Tensor,
    warped_live_gradient: torch.Tensor,
    canonical: torch.Tensor | None = None,
    band_union_only: bool = True,
    epsilon: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eikonal level-set term keeping ‖∇Φ_w‖ ≈ 1."""
    g = warped_live_gradient
    hess = derivatives.hessian(warped_live)
    norm = torch.sqrt(torch.sum(g * g, dim=-1))
    scale = (norm - 1.0) / (norm + epsilon)
    if band_union_only and canonical is not None:
        scale = torch.where(band_union_mask(canonical, warped_live), scale, 0.0)
    grad = scale[..., None] * torch.einsum("...ij,...j->...i", hess, g)
    return grad, level_set_energy(warped_live, g, canonical, band_union_only)


def level_set_energy(
    warped_live: torch.Tensor,
    warped_live_gradient: torch.Tensor,
    canonical: torch.Tensor | None = None,
    band_union_only: bool = True,
) -> torch.Tensor:
    """The level-set term's energy alone (of any rows of the fields and of
    the gradient)."""
    g = warped_live_gradient
    energy_terms = (torch.sqrt(torch.sum(g * g, dim=-1)) - 1.0) ** 2
    if band_union_only and canonical is not None:
        energy_terms = torch.where(band_union_mask(canonical, warped_live), energy_terms, 0.0)
    return 0.5 * torch.sum(energy_terms)
