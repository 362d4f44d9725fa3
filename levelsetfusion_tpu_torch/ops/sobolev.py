"""Sobolev gradient filtering. Twin of ``levelsetfusion_tpu/ops/sobolev.py``.

The separable 1D kernel is the central column of ``(I - λL)^{-1}`` for the
1-(-2)-1 Laplacian ``L`` truncated to ``size`` taps, normalized to unit sum.
Convolution is "same" size with zero padding at the array edges, along axis
0, then 1, then 2.
"""

from __future__ import annotations

import numpy as np
import torch


def generate_1d_sobolev_kernel(size: int = 7, strength: float = 0.1) -> np.ndarray:
    """The separable Sobolev smoothing kernel ``(I - λΔ)^{-1} δ``, unit-sum.

    Args:
      size: odd number of taps.
      strength: λ, the Sobolev smoothing strength.
    """
    if size < 3 or size % 2 == 0:
        raise ValueError(f"kernel size must be odd and >= 3, got {size}")
    lap = (
        -2.0 * np.eye(size)
        + np.eye(size, k=1)
        + np.eye(size, k=-1)
    )
    a = np.eye(size) - strength * lap
    delta = np.zeros(size)
    delta[size // 2] = 1.0
    kernel = np.linalg.solve(a, delta)
    kernel = kernel / kernel.sum()
    return kernel.astype(np.float32)


def _convolve_axis(field: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Same-size 1D convolution along ``axis`` with zero edge padding."""
    k = kernel.shape[0]
    r = k // 2
    n = field.shape[axis]
    pad_shape = list(field.shape)
    pad_shape[axis] = r
    zeros = field.new_zeros(pad_shape)
    fp = torch.cat([zeros, field, zeros], dim=axis)
    out = torch.zeros_like(field)
    for t in range(k):
        # Convolution (not correlation): tap t multiplies kernel[k-1-t].
        out = out + kernel[k - 1 - t] * fp.narrow(axis, t, n)
    return out


def convolve_with_sobolev_kernel(
    field: torch.Tensor,
    kernel: torch.Tensor,
    num_spatial_dims: int | None = None,
) -> torch.Tensor:
    """Separable filter: convolve along every spatial axis in turn.

    ``field`` may carry trailing channel axes (e.g. a warp gradient
    ``(*spatial, D)``); ``num_spatial_dims`` restricts the axes filtered.
    """
    d = field.ndim if num_spatial_dims is None else num_spatial_dims
    kernel = torch.as_tensor(kernel, dtype=field.dtype, device=field.device)
    out = field
    for ax in range(d):
        out = _convolve_axis(out, kernel, ax)
    return out
