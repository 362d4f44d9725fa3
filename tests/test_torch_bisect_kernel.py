"""Parity of the port's resample cost bisection
(levelsetfusion_tpu_torch/experiments/bisect_kernel.py) with the JAX script
experiments/bisect_kernel.py, which is loaded by path; its Pallas kernels run
in interpret mode on the CPU, and the port's wrappers take their plain torch
versions for CPU tensors (chip_smoke.py holds the CUDA kernel,
csrc/stack_bodies.cu, against the same plain versions on the card).

Tolerance against JAX: abs 1e-6, except level 1 (``_jax_atol``). Both sum
the same terms in the same order, but XLA on the CPU contracts w0 · r0 +
w1 · r1 into one FMA, which skips one rounding per term. Level 0's weights
0.5 and 0.25 make exact products, and levels 2–4, v8 and v8c weigh the terms
with tents, so their outputs stay below ~4 (4.8e-7 measured). Level 1 sums
36 unweighted terms of a random stack, up to 26.7 here, where one float32
step is 1.9e-6 (4.8e-6 measured, the contraction alone: a numpy sum with
that FMA matches JAX exactly), so it is held to 1e-6 per unit of its largest
magnitude. Against the golden ``warp_field`` (the
port's, on the clamped warp) abs 1e-5: the enumeration and the 8-corner
trilinear sum round in another order.

The script fixes X = 128 and Z = 128, and ``run``'s y block at 64: Y is 64
for the levels and 16 for v8 and v8c at yb 8 and 16."""

import functools

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.experiments import bisect_kernel as bk
from levelsetfusion_tpu_torch.experiments import loop_cost as lc
from levelsetfusion_tpu_torch.experiments import stack_bodies_sweep
from levelsetfusion_tpu_torch.experiments.resample_variants import clamp_warp
from levelsetfusion_tpu_torch.ops.interpolation import warp_field
from tests.torch_parity import assert_close, interpreted, n, t

X = 128


@pytest.fixture
def interpret(monkeypatch):
    """The JAX script ``name`` with its Pallas kernels in interpret mode."""
    return functools.partial(interpreted, monkeypatch)


def _jax_atol(want, level=None):
    if level != 1:
        return 1e-6
    return 1e-6 * max(1.0, float(np.max(np.abs(np.asarray(want)))))


def _stack_inputs(nx, ny, seed):
    """A random stack (6, X + 5, Y, 128) with independent planes, as the
    script's, a 1.5 N(0, 1) warp, and a field in (-1, 1)."""
    rng = np.random.default_rng(seed)
    stacked = rng.standard_normal((lc.N, nx + lc.N - 1, ny, lc.LANE)).astype(np.float32)
    warp = (rng.standard_normal((nx, ny, lc.LANE, 3)) * 1.5).astype(np.float32)
    field = np.tanh(rng.standard_normal((nx, ny, lc.LANE)) * 0.3).astype(np.float32)
    return stacked, warp, field


@pytest.mark.parametrize("level", range(5))
def test_level_matches_jax(level, interpret):
    jm = interpret("bisect_kernel")
    stacked, warp, _ = _stack_inputs(X, 64, 1)
    want = jm.run(stacked, warp, level)
    got = bk.run(t(stacked), t(warp), level)
    assert_close(got, want, rtol=0, atol=_jax_atol(want, level))


@pytest.mark.parametrize("yb", [8, 16])
@pytest.mark.parametrize("which", bk.WHICH)
def test_v8_matches_jax(which, yb, interpret):
    jm = interpret("bisect_kernel")
    stacked, warp, _ = _stack_inputs(X, 16, 2)
    want = jm.run_v8(stacked, warp, 1, yb, which)
    got = bk.run_v8(t(stacked), t(warp), yb, which)
    assert_close(got, want, rtol=0, atol=_jax_atol(want))


def test_level0_is_loop_cost_full():
    """The script's level 0 is loop_cost's full body under fori."""
    stacked, warp, _ = (t(a) for a in _stack_inputs(6, 64, 3))
    a = bk.run(stacked, warp, 0)
    b = lc.run(stacked, warp, "full", "fori")
    np.testing.assert_array_equal(n(a), n(b))


def test_level4_is_v8():
    stacked, warp, _ = (t(a) for a in _stack_inputs(6, 64, 4))
    np.testing.assert_array_equal(n(bk.run(stacked, warp, 4)),
                                  n(bk.run_v8(stacked, warp, 8, "v8")))
    # v8c adds the fill last: the same value up to rounding.
    assert_close(bk.run_v8(stacked, warp, 8, "v8c"), bk.run_v8(stacked, warp, 8, "v8"),
                 rtol=0, atol=1e-5)


def test_levels_differ():
    """Each level adds a feature that changes the value on a random stack."""
    stacked, warp, _ = (t(a) for a in _stack_inputs(6, 64, 5))
    outs = [bk.run(stacked, warp, level) for level in range(5)]
    for a, b in zip(outs, outs[1:]):
        assert float(torch.max(torch.abs(a - b))) > 1e-3


@pytest.mark.parametrize("call", [
    lambda s, w: bk.run(s, w, 4),
    lambda s, w: bk.run_v8(s, w, 8, "v8"),
    lambda s, w: bk.run_v8(s, w, 8, "v8c"),
], ids=["level4", "v8", "v8c"])
def test_real_stack_is_golden_resample(call):
    _, warp, field = (t(a) for a in _stack_inputs(7, 64, 6))
    got = call(bk.make_stack(field), warp)
    assert_close(got, warp_field(field, clamp_warp(warp)), rtol=0, atol=1e-5)


def test_make_stack_matches_script():
    """The stack the script builds in its v8 mode (jnp.pad, then the y
    windows)."""
    import jax.numpy as jnp

    _, _, field = _stack_inputs(5, 8, 7)
    padded = jnp.pad(field, ((2, 3), (2, 3), (0, 0)), constant_values=1.0)
    want = jnp.stack([padded[:, cy:cy + 8, :] for cy in range(6)])
    got = bk.make_stack(t(field))
    assert got.shape == (6, 10, 8, 128) and got.is_contiguous()
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_wrappers_cpu_take_plain_path():
    stacked, warp, _ = (t(a) for a in _stack_inputs(4, 64, 8))
    for out in (bk.run(stacked, warp, 2), bk.run_v8(stacked, warp, 8, "v8c")):
        assert out.shape == (4, 64, 128) and bool(torch.isfinite(out).all())
    assert bk.launch_counts == {"run": 0, "run_v8": 0}


def _bad_inputs():
    stacked, warp, _ = (t(a) for a in _stack_inputs(4, 64, 9))
    return {
        "stack too short in x": (ValueError, stacked[:, :8].contiguous(), warp),
        "z not 128": (ValueError, stacked[..., :64].contiguous(),
                      warp[:, :, :64].contiguous()),
        "dtype": (TypeError, stacked.double(), warp.double()),
        "strided": (ValueError, stacked.transpose(1, 2).contiguous().transpose(1, 2), warp),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
@pytest.mark.parametrize("entry", ["run", "run_v8"])
def test_wrapper_rejects_bad_input(entry, case):
    error, stacked, warp = _bad_inputs()[case]
    with pytest.raises(error):
        if entry == "run":
            bk.run(stacked, warp, 4)
        else:
            bk.run_v8(stacked, warp, 8, "v8")


@pytest.mark.parametrize("call", [
    lambda s, w: bk.run(s, w, 5),
    lambda s, w: bk.run(s, w, 4),  # yb 64 does not divide Y = 16
    lambda s, w: bk.run_v8(s, w, 12, "v8"),
    lambda s, w: bk.run_v8(s, w, 8, "v9"),
], ids=["level", "run yb", "v8 yb", "which"])
def test_wrapper_rejects_bad_option(call):
    stacked, warp, _ = (t(a) for a in _stack_inputs(4, 16, 10))
    with pytest.raises(ValueError):
        call(stacked, warp)


def test_inputs_are_the_scripts():
    """The script's draws in its order: stack, warp, then the field."""
    stacked, warp, field = bk.inputs("cpu", (128, 2))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        n(stacked), rng.standard_normal((6, 133, 2, 128)).astype(np.float32))
    np.testing.assert_array_equal(
        n(warp), (rng.standard_normal((128, 2, 128, 3)) * 1.5).astype(np.float32))
    np.testing.assert_array_equal(
        n(field), np.tanh(rng.standard_normal((128, 2, 128)) * 0.3).astype(np.float32))


def test_main_levels_cpu(capsys):
    rows = bk.main(device="cpu", shape=(4, 64))
    assert [(r["level"], r["name"]) for r in rows] == list(enumerate(bk.LEVEL_NAMES))
    assert capsys.readouterr().out.count('"device": "cpu"') == 5
    assert all(r["us_per_call"] > 0 for r in rows)
    assert bk.launch_counts == {"run": 0, "run_v8": 0}


def test_main_v8_cpu():
    rows = bk.main(device="cpu", mode="v8", shape=(3, 128))
    assert [(r["which"], r["yb"]) for r in rows] == [
        (w, yb) for w in bk.WHICH for yb in bk.V8_YBS]
    assert all(r["max_abs_err_vs_golden"] <= 1e-5 and r["us_per_call"] > 0 for r in rows)


@pytest.mark.parametrize("mode", [None, "v8"])
def test_entry_point_requires_cuda(mode):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bk.main(mode=mode, shape=(2, 128))


@pytest.mark.parametrize("name", list(stack_bodies_sweep.VARIANTS))
def test_sweep_variant_applies_to_the_kernel_source(name):
    """Every substitution of the table sweep finds its anchor exactly once
    in csrc/stack_bodies.cu, so each variant built on the card is the one
    the sweep names."""
    text = stack_bodies_sweep.variant_source(name)
    assert ("__global__" in text) and (text != stack_bodies_sweep.SOURCE.read_text()
                                       or name == "base")


def test_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        stack_bodies_sweep.main(device="cpu")
