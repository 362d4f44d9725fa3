"""Parity of the port's pyramids (``ops/pyramid.py``) with the JAX
package's, on seeded fields and warps in 2D and 3D.

Tolerances: block means atol 1e-7 (a mean of 4 or 8 values, summed in
another order); the prolongation atol 1e-6 (``F.interpolate`` against
``jax.image.resize``: the same two taps a component and axis, weighted in
another order; both take the edge voxel's value at the border, JAX by
renormalising the one in-range tap, torch by clamping the coordinate)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.ops import pyramid as jpyr
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.ops import pyramid as tpyr
from tests.torch_parity import assert_close, n, t


@pytest.mark.parametrize("shape", [(12, 6), (8, 6, 4), (2, 2)])
def test_downsample_matches_jax(shape):
    field = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tpyr.downsample2x_mean(t(field))
    assert got.shape == tuple(s // 2 for s in shape)
    assert_close(got, jpyr.downsample2x_mean(jnp.asarray(field)), 0.0, 1e-7)


def test_downsample_rejects_odd_shapes():
    with pytest.raises(ValueError, match="divisible"):
        tpyr.downsample2x_mean(torch.zeros(6, 5))


@pytest.mark.parametrize("levels", [1, 3])
def test_build_pyramid_matches_jax(levels):
    field = np.random.default_rng(2).standard_normal((16, 8, 4)).astype(np.float32)
    got, want = tpyr.build_pyramid(t(field), levels), jpyr.build_pyramid(jnp.asarray(field), levels)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert_close(g, w, 0.0, 1e-7)


@pytest.mark.parametrize("shape", [(12, 6), (3, 5), (8, 6, 4), (2, 3, 2), (24, 16)])
def test_prolongate_matches_jax(shape):
    """×2 multi-linear upsampling with doubled displacements, the edges
    included, on shapes with extents of 2 and 3."""
    warp = np.random.default_rng(3).standard_normal(shape + (len(shape),)).astype(np.float32)
    got = tpyr.prolongate_warp(t(warp))
    want = jpyr.prolongate_warp(jnp.asarray(warp))
    assert got.shape == want.shape == tuple(2 * s for s in shape) + (len(shape),)
    assert_close(got, want, 0.0, 1e-6)


def test_prolongate_to_the_next_level_shape():
    """The hierarchical solve passes the finer level's shape."""
    warp = np.random.default_rng(4).standard_normal((12, 8, 2)).astype(np.float32)
    got = tpyr.prolongate_warp(t(warp), target_shape=(24, 16))
    want = jpyr.prolongate_warp(jnp.asarray(warp), target_shape=(24, 16))
    assert_close(got, want, 0.0, 1e-6)
    # A constant warp stays constant, doubled.
    const = tpyr.prolongate_warp(torch.full((5, 4, 2), 0.75))
    np.testing.assert_array_equal(n(const), np.full((10, 8, 2), 1.5, np.float32))


def test_coarsened_grid_matches_jax():
    kw = dict(shape=(96, 64), voxel_size=0.004, offset=(-48, 75))
    got, want = GridSpec(**kw).coarsened(2), JGrid(**kw).coarsened(2)
    assert (got.shape, got.voxel_size, got.offset) == (want.shape, want.voxel_size, want.offset)
