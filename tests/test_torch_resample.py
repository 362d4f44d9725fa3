"""Parity of the port's interpolation and of the resample kernel's plain
path with the JAX package.

On the CPU, ``warp_field_cm`` takes its plain version (the CUDA kernel is
held against it on the card by chip_smoke.py). Tolerance rtol/atol 1e-6:
the same f32 steps in the same corner order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.ops import interpolation as ji
from levelsetfusion_tpu.ops.pallas.resample import warp_field_pallas
from levelsetfusion_tpu_torch.experiments import resample_sweep
from levelsetfusion_tpu_torch.ops import interpolation as ti
from levelsetfusion_tpu_torch.ops.kernels import resample as kr
from tests.torch_parity import assert_close, c_prototype, ctypes_kind, n, t


def _field_and_warp(shape, seed, lo, hi):
    rng = np.random.default_rng(seed)
    field = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    warp = rng.uniform(lo, hi, shape + (len(shape),)).astype(np.float32)
    return field, warp


@pytest.mark.parametrize(
    "shape,scale",
    [((13, 10, 9), 4.0), ((16, 16, 128), 3.0), ((11, 17), 5.0), ((5, 4, 3), 8.0)],
)
def test_warp_field_matches_jax(shape, scale):
    """Out-of-volume warps included (|u| up to ``scale`` voxels)."""
    field, warp = _field_and_warp(shape, 10, -scale, scale)
    want = ji.warp_field(jnp.asarray(field), jnp.asarray(warp))
    assert_close(ti.warp_field(t(field), t(warp)), want, rtol=1e-6, atol=1e-6)
    got, got_grad = ti.warp_field_with_gradient(t(field), t(warp))
    want, want_grad = ji.warp_field_with_gradient(jnp.asarray(field), jnp.asarray(warp))
    assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert_close(got_grad, want_grad, rtol=1e-6, atol=1e-6)


def test_sample_at_fill_and_identity_positions():
    field, _ = _field_and_warp((6, 5, 4), 11, 0, 1)
    pos = np.random.default_rng(12).uniform(-3, 9, (40, 3)).astype(np.float32)
    for fill in (1.0, -0.5):
        assert_close(ti.sample_at(t(field), t(pos), fill),
                     ji.sample_at(jnp.asarray(field), jnp.asarray(pos), fill),
                     rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        n(ti.identity_positions((6, 5, 4), "cpu")), n(ji.identity_positions((6, 5, 4)))
    )
    # Far outside: every corner reads the fill.
    far = torch.full((3, 3), 100.0)
    np.testing.assert_array_equal(n(ti.sample_at(t(field), far)), np.ones(3, np.float32))


@pytest.mark.parametrize("shape", [(13, 10, 9), (12, 9)])
def test_warp_field_cm_cpu_is_plain_and_counts_nothing(shape):
    """On CPU tensors the wrapper is the plain version, in the component-
    major layout, and launches nothing."""
    field, warp = _field_and_warp(shape, 13, -3, 3)
    warp_cm = t(np.moveaxis(warp, -1, 0).copy())
    before = kr.launch_count
    got = kr.warp_field_cm(t(field), warp_cm)
    assert kr.launch_count == before
    assert_close(got, ji.warp_field(jnp.asarray(field), jnp.asarray(warp)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(got), n(kr.warp_field_cm_reference(t(field), warp_cm)))


def test_warp_field_cm_2d_as_3d_is_exact():
    """The CUDA path runs 2D as (X, 1, Z) with zero y displacement; on the
    CPU that mapping must give the 2D result bit for bit."""
    field, warp = _field_and_warp((12, 9), 14, -3, 3)
    warp_cm = t(np.moveaxis(warp, -1, 0).copy())
    live3, warp3 = kr._as_3d(t(field), warp_cm)
    got = kr.warp_field_cm_reference(live3, warp3)[:, 0, :]
    np.testing.assert_array_equal(n(got), n(kr.warp_field_cm_reference(t(field), warp_cm)))


def test_matches_tpu_kernel_in_interpret_mode():
    """Against the Pallas resample itself (interpret mode) where it is exact:
    |u| <= its clamp K = 2 at (16, 16, 128)."""
    field, warp = _field_and_warp((16, 16, 128), 15, -2, 2)
    want = warp_field_pallas(jnp.asarray(field), jnp.asarray(warp), max_displacement=2,
                             interpret=True)
    got = kr.warp_field_cm(t(field), t(np.moveaxis(warp, -1, 0).copy()))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "live,warp_cm,err",
    [
        (torch.zeros(4, 4, 4), torch.zeros(4, 4, 4, 3), ValueError),  # not component-major
        (torch.zeros(4, 4, 4, dtype=torch.float64), torch.zeros(3, 4, 4, 4), TypeError),
        (torch.zeros(4, 4, 4), torch.zeros(4, 4, 4, 3).movedim(-1, 0), ValueError),  # strided
        (torch.zeros(4), torch.zeros(1, 4), ValueError),  # 1D
    ],
)
def test_warp_field_cm_rejects_bad_inputs(live, warp_cm, err):
    with pytest.raises(err):
        kr.warp_field_cm(live, warp_cm)


def test_argtypes_match_c_prototype():
    """A mismatch would pass arguments in the wrong registers at launch,
    which nothing on the CPU can see."""
    assert [ctypes_kind(a) for a in kr.ARGTYPES] == c_prototype("resample.cu",
                                                               "lsf_warp_field_cm")


@pytest.mark.parametrize("name", list(resample_sweep.VARIANTS))
def test_sweep_variant_applies_to_the_kernel_source(name):
    """Every substitution of the sweep finds its anchor exactly once in
    csrc/resample.cu, so the variants built on the card are the ones the
    sweep names."""
    text = resample_sweep.variant_source(name)
    assert ("__global__" in text) and (text != resample_sweep.SOURCE.read_text()
                                       or name == "base")


def test_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        resample_sweep.main(device="cpu")
