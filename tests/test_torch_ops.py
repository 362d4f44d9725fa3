"""Parity of the port's plain ops — derivatives, energy terms, the Sobolev
filter and the gradient assembly — with the JAX package on the same seeded
inputs, 3D and 2D.

Tolerances: derivatives and elementwise terms rtol/atol 1e-6 (the same f32
operations; XLA may contract or reorder a few); energies rtol 1e-5 (sums
over the volume in another order); gradient assembly rtol/atol 2e-5 (the
tolerance of tests/test_fused_gradient.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfusion_tpu.ops import derivatives as jd
from levelsetfusion_tpu.ops import gradient as jg
from levelsetfusion_tpu.ops import sobolev as js
from levelsetfusion_tpu.ops import terms as jt
from levelsetfusion_tpu_torch.ops import derivatives as td
from levelsetfusion_tpu_torch.ops import gradient as tg
from levelsetfusion_tpu_torch.ops import sobolev as ts
from levelsetfusion_tpu_torch.ops import terms as tt
from tests.torch_parity import assert_close, t, tsdf_like

SHAPES = [(7, 6, 5), (9, 11)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", ["gradient", "hessian", "laplacian"])
def test_scalar_derivatives(shape, op):
    f = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    assert_close(getattr(td, op)(t(f)), getattr(jd, op)(jnp.asarray(f)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize(
    "op", ["vector_jacobian", "divergence", "gradient_of_divergence", "laplacian"]
)
def test_vector_derivatives(shape, op):
    _, _, u = tsdf_like(shape, 4)
    kw = {"num_spatial_dims": len(shape)} if op == "laplacian" else {}
    assert_close(getattr(td, op)(t(u), **kw), getattr(jd, op)(jnp.asarray(u), **kw),
                 rtol=1e-6, atol=1e-6)


def test_gradient_edges_and_degenerate_axes():
    """np.gradient edges on a length-2 axis, zeros on a length-1 axis."""
    f = np.random.default_rng(5).standard_normal((2, 1, 4)).astype(np.float32)
    assert_close(td.gradient(t(f)), jd.gradient(jnp.asarray(f)), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(td.gradient(t(f)).numpy()[..., 0],
                                  np.gradient(f, axis=0))
    assert_close(td.laplacian(t(f)), jd.laplacian(jnp.asarray(f)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("band_union", [True, False])
def test_data_and_level_set_terms(shape, band_union):
    canonical, live, _ = tsdf_like(shape, 6)
    live[0] = 1.0
    canonical[0] = -1.0  # a slab where both fields are truncated
    tgrad, jgrad = td.gradient(t(live)), jd.gradient(jnp.asarray(live))
    np.testing.assert_array_equal(
        tt.band_union_mask(t(canonical), t(live)).numpy(),
        np.asarray(jt.band_union_mask(jnp.asarray(canonical), jnp.asarray(live))),
    )
    g1, e1 = tt.data_term(t(live), t(canonical), tgrad, band_union_only=band_union)
    g2, e2 = jt.data_term(jnp.asarray(live), jnp.asarray(canonical), jgrad,
                          band_union_only=band_union)
    assert_close(g1, g2, rtol=1e-6, atol=1e-6)
    assert_close(e1, e2, rtol=1e-5)
    g1, e1 = tt.level_set_term(t(live), tgrad, t(canonical), band_union_only=band_union)
    g2, e2 = jt.level_set_term(jnp.asarray(live), jgrad, jnp.asarray(canonical),
                               band_union_only=band_union)
    assert_close(g1, g2, rtol=1e-5, atol=1e-6)
    assert_close(e1, e2, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("killing", [False, True])
def test_smoothing_terms(shape, killing):
    _, _, u = tsdf_like(shape, 7)
    if killing:
        g1, e1 = tt.killing_term(t(u), 0.1)
        g2, e2 = jt.killing_term(jnp.asarray(u), 0.1)
    else:
        g1, e1 = tt.tikhonov_term(t(u))
        g2, e2 = jt.tikhonov_term(jnp.asarray(u))
    assert_close(g1, g2, rtol=1e-6, atol=1e-6)
    assert_close(e1, e2, rtol=1e-5)


@pytest.mark.parametrize("size,strength", [(7, 0.1), (5, 0.3), (9, 0.05)])
def test_sobolev_kernel_and_filter(size, strength):
    k = ts.generate_1d_sobolev_kernel(size, strength)
    np.testing.assert_array_equal(k, js.generate_1d_sobolev_kernel(size, strength))
    rng = np.random.default_rng(8)
    field = rng.standard_normal((6, 5, 8, 3)).astype(np.float32)
    assert_close(
        ts.convolve_with_sobolev_kernel(t(field), t(k), num_spatial_dims=3),
        js.convolve_with_sobolev_kernel(jnp.asarray(field), jnp.asarray(k), num_spatial_dims=3),
        rtol=1e-6, atol=1e-6,
    )
    with pytest.raises(ValueError):
        ts.generate_1d_sobolev_kernel(4, 0.1)


GRADIENT_CASES = [
    # (shape, smoothing_mode, w_smooth, w_ls, sobolev, band_union)
    ((10, 9, 8), "KILLING", 0.1, 0.1, True, True),  # the config3 energy
    ((10, 9, 8), "TIKHONOV", 0.2, 0.0, False, True),
    ((10, 9, 8), "TIKHONOV", 0.2, 0.1, True, False),
    ((10, 9, 8), "KILLING", 0.0, 0.0, False, True),
    ((12, 10), "TIKHONOV", 0.2, 0.1, True, True),
    ((12, 10), "KILLING", 0.1, 0.0, False, True),
]


@pytest.mark.parametrize("shape,mode,w_smooth,w_ls,sobolev,band_union", GRADIENT_CASES)
def test_warp_energy_gradient(shape, mode, w_smooth, w_ls, sobolev, band_union):
    canonical, live, warp = tsdf_like(shape, 9, warp_scale=0.6)
    k = js.generate_1d_sobolev_kernel(7, 0.1) if sobolev else None
    kw = dict(data_term_weight=1.0, smoothing_term_weight=w_smooth,
              level_set_term_weight=w_ls, rigidity_enforcement_factor=0.1,
              band_union_only=band_union)
    got = tg.warp_energy_gradient(
        t(canonical), t(live), t(warp), smoothing_mode=tg.SmoothingMode[mode],
        sobolev_kernel=None if k is None else t(k), **kw)
    want = jg.warp_energy_gradient(
        jnp.asarray(canonical), jnp.asarray(live), jnp.asarray(warp),
        smoothing_mode=jg.SmoothingMode[mode],
        sobolev_kernel=None if k is None else jnp.asarray(k), **kw)
    assert_close(got.warped_live, want.warped_live, rtol=1e-6, atol=1e-6)
    assert_close(got.gradient, want.gradient, rtol=2e-5, atol=2e-5)
    for a, b in zip(got.energies, want.energies):
        assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert_close(got.energies.total, want.energies.total, rtol=1e-5)


# advect_field (the forward splat) on tests/test_interpolation.py's cases and
# seeded random warps: atol 1e-6 (the same f32 products, scatter-adds summed in
# another order).
def _advect_cases():
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(*[np.arange(8.0)] * 3, indexing="ij")
    bump = np.zeros((5, 5), np.float32)
    bump[1, 1] = -0.5
    return {
        "zero_warp": (rng.uniform(-1, 1, (6, 5)).astype(np.float32),
                      np.zeros((6, 5, 2), np.float32)),
        "integer_shift": (bump, np.full((5, 5, 2), 2.0, np.float32)),
        "constant_shift_3d": ((0.05 * x + 0.03 * y - 0.02 * z).astype(np.float32),
                              np.full((8, 8, 8, 3), 1.5, np.float32)),
        "random_2d": (rng.uniform(-1, 1, (9, 7)).astype(np.float32),
                      rng.uniform(-2.5, 2.5, (9, 7, 2)).astype(np.float32)),
        "random_3d": (rng.uniform(-1, 1, (7, 6, 5)).astype(np.float32),
                      rng.uniform(-2.5, 2.5, (7, 6, 5, 3)).astype(np.float32)),
    }


@pytest.mark.parametrize("case", ["zero_warp", "integer_shift", "constant_shift_3d",
                                  "random_2d", "random_3d"])
def test_advect_field_matches_jax(case):
    from levelsetfusion_tpu.ops.interpolation import advect_field as jadvect
    from levelsetfusion_tpu_torch.ops.interpolation import advect_field

    field, warp = _advect_cases()[case]
    got = advect_field(t(field), t(warp))
    assert_close(got, jadvect(jnp.asarray(field), jnp.asarray(warp)), rtol=0.0, atol=1e-6)
    if case == "integer_shift":
        assert float(got[3, 3]) == -0.5 and bool((got[0] == 1.0).all())


def test_advect_field_checks_shapes():
    from levelsetfusion_tpu_torch.ops.interpolation import advect_field

    with pytest.raises(ValueError, match="warp"):
        advect_field(t(np.zeros((4, 4), np.float32)), t(np.zeros((4, 4, 3), np.float32)))
