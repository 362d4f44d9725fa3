"""Field warping / interpolation. Twin of
``levelsetfusion_tpu/ops/interpolation.py``.

- Sample positions are in voxel/index units of the same grid.
- Every out-of-bounds corner reads the truncation value ``+1.0``, so
  interpolation near the border blends with that fill.
- ``warp`` holds per-voxel displacements in voxel units, component ``d``
  along array axis ``d``.

These are the plain versions. The solve loop's resample goes through the
CUDA kernel in ``ops/kernels/resample.py``, which computes exactly this.
``advect_field`` (the forward splat) runs in no kernel, in JAX as here.
"""

from __future__ import annotations

import itertools
import math

import torch

from levelsetfusion_tpu_torch.ops.derivatives import gradient

TRUNCATION_FILL = 1.0


def sample_at(
    field: torch.Tensor,
    positions: torch.Tensor,
    fill_value: float = TRUNCATION_FILL,
) -> torch.Tensor:
    """Multi-linear interpolation of ``field`` at fractional index positions.

    Args:
      field: scalar field ``(*spatial,)``.
      positions: ``(..., D)`` fractional index coordinates.
      fill_value: value assumed outside the grid.

    Returns a tensor of shape ``positions.shape[:-1]``. Corners are summed in
    ``itertools.product`` order, each weight a left-to-right product over
    the axes, as the JAX twin does.
    """
    d = field.ndim
    if positions.shape[-1] != d:
        raise ValueError(f"positions {tuple(positions.shape)} for a {d}D field")
    floor = torch.floor(positions)
    frac = positions - floor
    base = floor.to(torch.int64)

    out = None
    for corner in itertools.product((0, 1), repeat=d):
        idx = [base[..., ax] + corner[ax] for ax in range(d)]
        weight = None
        for ax in range(d):
            w_ax = frac[..., ax] if corner[ax] else 1.0 - frac[..., ax]
            weight = w_ax if weight is None else weight * w_ax
        in_bounds = None
        for ax in range(d):
            ok = (idx[ax] >= 0) & (idx[ax] < field.shape[ax])
            in_bounds = ok if in_bounds is None else in_bounds & ok
        clipped = tuple(
            torch.clamp(idx[ax], 0, field.shape[ax] - 1) for ax in range(d)
        )
        value = torch.where(in_bounds, field[clipped], fill_value)
        contrib = weight * value
        out = contrib if out is None else out + contrib
    return out


def identity_positions(
    shape, device: torch.device | str, dtype=torch.float32
) -> torch.Tensor:
    """Index-coordinate grid ``(*shape, D)``: position of every voxel."""
    axes = [torch.arange(n, dtype=dtype, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def warp_field(
    field: torch.Tensor,
    warp: torch.Tensor,
    fill_value: float = TRUNCATION_FILL,
) -> torch.Tensor:
    """Resample ``field`` at ``x + warp(x)``."""
    pos = identity_positions(field.shape, field.device, warp.dtype) + warp
    return sample_at(field, pos, fill_value=fill_value)


def warp_field_with_gradient(
    field: torch.Tensor,
    warp: torch.Tensor,
    fill_value: float = TRUNCATION_FILL,
):
    """Warped field and the np.gradient-style gradient of the *resampled*
    field."""
    warped = warp_field(field, warp, fill_value=fill_value)
    return warped, gradient(warped)


def advect_field(
    field: torch.Tensor,
    warp: torch.Tensor,
    fill_value: float = TRUNCATION_FILL,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Forward-warp: push each voxel's value to ``x + u(x)``, splatting with
    multilinear weights and normalising by the accumulated weight; target
    voxels no source reaches get ``fill_value``.

    The backward flavour (``warp_field``) asks what was at the place a voxel
    came from; this one asks where a voxel's value goes. Corners go in JAX's
    order (bit k of the corner number is the offset along axis k), each a
    scatter-add (``index_add_``) on flat indices; the sums' order on the card
    is not fixed, so values agree to rounding."""
    d = field.ndim
    if tuple(warp.shape) != (*field.shape, d):
        raise ValueError(f"warp {tuple(warp.shape)} for a field {tuple(field.shape)}")
    pos = identity_positions(field.shape, field.device, warp.dtype) + warp
    base = torch.floor(pos)
    frac = pos - base
    base_i = base.to(torch.int64)
    strides = [math.prod(field.shape[k + 1:]) for k in range(d)]
    values = torch.zeros(field.numel(), dtype=field.dtype, device=field.device)
    weights = torch.zeros_like(values)
    for corner in range(2**d):
        flat = torch.zeros(field.shape, dtype=torch.int64, device=field.device)
        w = torch.ones_like(field)
        inb = torch.ones(field.shape, dtype=torch.bool, device=field.device)
        for k in range(d):
            off = (corner >> k) & 1
            idx = base_i[..., k] + off
            w = w * (frac[..., k] if off else 1.0 - frac[..., k])
            inb &= (idx >= 0) & (idx < field.shape[k])
            flat += torch.clamp(idx, 0, field.shape[k] - 1) * strides[k]
        w = torch.where(inb, w, 0.0)
        values.index_add_(0, flat.view(-1), (w * field).view(-1))
        weights.index_add_(0, flat.view(-1), w.view(-1))
    values, weights = values.view(field.shape), weights.view(field.shape)
    return torch.where(weights > eps, values / torch.clamp(weights, min=eps), fill_value)
