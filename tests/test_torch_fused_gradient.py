"""Parity of the fused gradient/update's plain version with the JAX package:
against the Pallas kernel in interpret mode for the CASES of
tests/test_fused_gradient.py at (16, 16, 128), and against the golden jnp
assembly at a ragged shape the TPU kernel cannot take.

Tolerances are those of tests/test_fused_gradient.py: warp rtol/atol 2e-5,
energies and sums rtol 1e-4, maxes rtol 1e-4 atol 1e-7. On the CPU the
wrapper takes the plain version; chip_smoke.py holds the CUDA kernels
against it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.ops import sobolev as jsob
from levelsetfusion_tpu.ops import terms as jterms
from levelsetfusion_tpu.ops.derivatives import gradient as jgradient
from levelsetfusion_tpu.ops.pallas import fused_gradient as jfg
from levelsetfusion_tpu_torch.experiments import fused_gradient_sweep
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient as kfg
from tests.torch_parity import assert_close, c_prototype, ctypes_kind, n, t, tsdf_like

# (w_smooth, w_ls, killing, sobolev, band_union), as tests/test_fused_gradient.py
CASES = [
    (0.2, 0.0, False, False, True),
    (0.2, 0.1, True, False, True),
    (0.1, 0.1, True, True, True),
    (0.2, 0.1, False, True, False),
    (0.0, 0.0, False, False, True),
]


def _golden_jnp(warped, canonical, warp, rate, *, w_data, w_smooth, w_ls,
                killing, gamma, band_union, kernel):
    """The JAX package's golden assembly from an already-warped field (the
    _golden of tests/test_fused_gradient.py), stats in FusedStats order."""
    wg = jgradient(warped)
    g, e_data = jterms.data_term(warped, canonical, wg, band_union_only=band_union)
    total, e_data = w_data * g, w_data * e_data
    e_smooth = e_ls = jnp.zeros(())
    if w_smooth:
        g, e_smooth = (jterms.killing_term(warp, gamma) if killing
                       else jterms.tikhonov_term(warp))
        total, e_smooth = total + w_smooth * g, w_smooth * e_smooth
    if w_ls:
        g, e_ls = jterms.level_set_term(warped, wg, canonical, band_union_only=band_union)
        total, e_ls = total + w_ls * g, w_ls * e_ls
    if kernel is not None:
        total = jsob.convolve_with_sobolev_kernel(total, kernel, num_spatial_dims=3)
    upd = -rate * total
    new_warp = warp + upd
    ul = jnp.sqrt(jnp.sum(upd * upd, axis=-1))
    stats = jnp.stack([e_data, e_smooth, e_ls, jnp.sum(ul), jnp.max(ul),
                       *jnp.max(jnp.abs(new_warp), axis=(0, 1, 2))])
    return new_warp, stats


def _check(got_warp_cm, got_stats, want_warp, want_stats):
    assert got_warp_cm.shape == (3, *want_warp.shape[:3])
    assert_close(kfg.from_component_major(got_warp_cm), want_warp, rtol=2e-5, atol=2e-5)
    assert_close(got_stats[:4], want_stats[:4], rtol=1e-4, atol=1e-7)
    assert_close(got_stats[4:], want_stats[4:], rtol=1e-4, atol=1e-7)


def _kwargs(w_smooth, w_ls, killing, sobolev, band_union):
    return dict(w_data=1.0, w_smooth=w_smooth, w_ls=w_ls, killing=killing, gamma=0.1,
                band_union=band_union, taps=kfg.sobolev_taps(7, 0.1) if sobolev else ())


@pytest.mark.parametrize("case", CASES)
def test_matches_tpu_kernel_in_interpret_mode(case):
    canonical, warped, warp = tsdf_like((16, 16, 128), 20)
    kw = _kwargs(*case)
    want_warp_cm, want = jfg.fused_gradient_update(
        jnp.asarray(warped), jnp.asarray(canonical), jnp.moveaxis(jnp.asarray(warp), -1, 0),
        jnp.float32(0.3), interpret=True, **kw)
    before = kfg.launch_count
    got_warp_cm, got_stats = kfg.fused_gradient_update(
        t(warped), t(canonical), kfg.to_component_major(t(warp)), torch.tensor(0.3), **kw)
    assert kfg.launch_count == before  # CPU tensors: the plain version
    want_stats = jnp.concatenate([jnp.stack(list(want[:5])), want.max_abs_u])
    _check(got_warp_cm, got_stats, np.moveaxis(n(want_warp_cm), 0, -1), want_stats)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(13, 10, 9), (3, 4, 5), (9, 33, 300), (1, 6, 130)])
def test_ragged_shape_matches_golden(case, shape):
    """Shapes the TPU kernel's gates refuse; every row is a global edge row
    at (3, 4, 5). (9, 33, 300) and (1, 6, 130) straddle the CUDA kernels'
    tiles (8 x 32 and 16 x 32 (y, z) columns: z over many tiles with a
    ragged tail, an extent of 1); chip_smoke.py holds the kernels to this
    plain version at the same shapes."""
    canonical, warped, warp = tsdf_like(shape, 21)
    kw = _kwargs(*case)
    kernel = jnp.asarray(jsob.generate_1d_sobolev_kernel(7, 0.1)) if case[3] else None
    want_warp, want_stats = _golden_jnp(
        jnp.asarray(warped), jnp.asarray(canonical), jnp.asarray(warp), jnp.float32(0.25),
        kernel=kernel, **{k: v for k, v in kw.items() if k != "taps"})
    got_warp_cm, got_stats = kfg.fused_gradient_update_reference(
        t(warped), t(canonical), kfg.to_component_major(t(warp)), torch.tensor(0.25), **kw)
    _check(got_warp_cm, got_stats, want_warp, want_stats)


def test_helpers_match_jax():
    assert kfg.sobolev_taps(7, 0.1) == jfg.sobolev_taps(7, 0.1)
    assert kfg.STATS_FIELDS[:5] == jfg.FusedStats._fields[:5]
    w = torch.arange(24, dtype=torch.float32).reshape(2, 2, 2, 3)
    cm = kfg.to_component_major(w)
    assert cm.shape == (3, 2, 2, 2) and cm.is_contiguous()
    np.testing.assert_array_equal(n(kfg.from_component_major(cm)), n(w))


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(rate=0.3), TypeError),  # a float, not a 0-d tensor
        (dict(warp_cm=torch.zeros(4, 4, 4, 3)), ValueError),  # not component-major
        (dict(canonical=torch.zeros(4, 4, 5)), ValueError),
        (dict(warped=torch.zeros(4, 4, 4, dtype=torch.float64)), TypeError),
        (dict(taps=(0.25, 0.5, 0.25, 0.0)), ValueError),  # even tap count
        (dict(taps=(1.0 / 17,) * 17), ValueError),  # more taps than the kernel holds
    ],
)
def test_rejects_bad_inputs(change, err):
    args = dict(warped=torch.zeros(4, 4, 4), canonical=torch.zeros(4, 4, 4),
                warp_cm=torch.zeros(3, 4, 4, 4), rate=torch.tensor(0.3), taps=())
    args.update(change)
    with pytest.raises(err):
        kfg.fused_gradient_update(args.pop("warped"), args.pop("canonical"),
                                  args.pop("warp_cm"), args.pop("rate"), **args)


@pytest.mark.parametrize("name,argtypes", [
    ("lsf_fused_gradient_update", kfg.UPDATE_ARGTYPES),
    ("lsf_fused_partials_len", kfg.PARTIALS_ARGTYPES),
])
def test_argtypes_match_c_prototype(name, argtypes):
    """A mismatch would pass arguments in the wrong registers at launch,
    which nothing on the CPU can see."""
    assert [ctypes_kind(a) for a in argtypes] == c_prototype("fused_gradient.cu", name)


@pytest.mark.parametrize("name", list(fused_gradient_sweep.VARIANTS))
def test_sweep_variant_applies_to_the_kernel_source(name):
    """Every substitution of the sweep finds its anchor exactly once in
    csrc/fused_gradient.cu, so the variants built on the card are the ones
    the sweep names."""
    text = fused_gradient_sweep.variant_source(name)
    assert ("__global__" in text) and (text != fused_gradient_sweep.SOURCE.read_text()
                                       or name == "base")


def test_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        fused_gradient_sweep.main(device="cpu")


def test_ticket_is_one_per_stream():
    """Calls in flight on two streams count their completion on two
    tickets; calls on one stream, which run in order, share one."""
    cpu, shape = torch.device("cpu"), (4, 5, 6)
    first, second = kfg._ticket(cpu, shape, 101), kfg._ticket(cpu, shape, 102)
    assert first is not second and first.data_ptr() != second.data_ptr()
    assert kfg._ticket(cpu, shape, 101) is first
    assert int(first.item()) == int(second.item()) == 0
