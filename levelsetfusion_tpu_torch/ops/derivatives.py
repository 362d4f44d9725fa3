"""Finite-difference derivative operators. Twin of
``levelsetfusion_tpu/ops/derivatives.py``; the numerical spec is the same:

- ``gradient(f)``      — np.gradient convention: central differences inside,
  one-sided first differences at the array edges, unit spacing. Returns
  ``(*spatial, D)``.
- ``hessian(f)``       — gradient of each gradient component,
  ``(*spatial, D, D)`` with ``H[..., i, j] = d_j(d_i f)``.
- ``laplacian(v)``     — per-axis 1-(-2)-1 stencil with replicated (Neumann)
  edges.
- ``vector_jacobian(u)`` — ``J[..., c, d] = d u_c / d x_d``.
- ``divergence(u)``, ``gradient_of_divergence(u)`` — np.gradient edges.

All operators are dimension-generic (2D/3D) plain torch.
"""

from __future__ import annotations

import torch


def _diff_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """np.gradient along one axis: central interior, one-sided edges."""
    n = f.shape[axis]
    if n < 2:
        return torch.zeros_like(f)
    center = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5
    first = f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)
    last = f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)
    return torch.cat([first, center, last], dim=axis)


def gradient(field: torch.Tensor, num_spatial_dims: int | None = None) -> torch.Tensor:
    """Spatial gradient, np.gradient convention, unit spacing.

    ``field`` may have trailing non-spatial axes; ``num_spatial_dims``
    restricts differentiation to the leading axes (default ``field.ndim``).
    Returns ``field.shape + (num_spatial_dims,)``.
    """
    d = field.ndim if num_spatial_dims is None else num_spatial_dims
    return torch.stack([_diff_axis(field, ax) for ax in range(d)], dim=-1)


def hessian(field: torch.Tensor) -> torch.Tensor:
    """Hessian of a scalar field, ``(*spatial, D, D)``, as
    gradient(gradient(f)) with np.gradient edges both times."""
    g = gradient(field)
    d = field.ndim
    return torch.stack(
        [gradient(g[..., i], num_spatial_dims=d) for i in range(d)], dim=-2
    )


def _second_diff_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """1-(-2)-1 stencil with replicated (Neumann) edges along ``axis``."""
    n = f.shape[axis]
    fp = torch.cat([f.narrow(axis, 0, 1), f, f.narrow(axis, n - 1, 1)], dim=axis)
    return fp.narrow(axis, 2, n) - 2.0 * f + fp.narrow(axis, 0, n)


def laplacian(field: torch.Tensor, num_spatial_dims: int | None = None) -> torch.Tensor:
    """Per-component Laplacian with replicated edges; same shape as input."""
    d = field.ndim if num_spatial_dims is None else num_spatial_dims
    out = _second_diff_axis(field, 0)
    for ax in range(1, d):
        out = out + _second_diff_axis(field, ax)
    return out


def vector_jacobian(warp: torch.Tensor) -> torch.Tensor:
    """Jacobian of a vector field ``(*spatial, D)`` -> ``(*spatial, D, D)``."""
    d = warp.shape[-1]
    return torch.stack(
        [gradient(warp[..., c], num_spatial_dims=warp.ndim - 1) for c in range(d)],
        dim=-2,
    )


def divergence(warp: torch.Tensor) -> torch.Tensor:
    """∇·u of a vector field ``(*spatial, D)`` (np.gradient convention)."""
    d = warp.shape[-1]
    out = _diff_axis(warp[..., 0], 0)
    for c in range(1, d):
        out = out + _diff_axis(warp[..., c], c)
    return out


def gradient_of_divergence(warp: torch.Tensor) -> torch.Tensor:
    """∇(∇·u): shape ``(*spatial, D)`` (np.gradient convention twice)."""
    return gradient(divergence(warp), num_spatial_dims=warp.ndim - 1)
