"""Parity of the port's single-level solve with the JAX package's, on the
golden path and on the fused Pallas path (interpret mode).

Tolerances are those of tests/test_fused_gradient.py's solver test: warp
rtol 3e-4 atol 3e-6, telemetry rtol 2e-4 atol 1e-8; iteration counts and
``converged`` exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.models import params as jparams
from levelsetfusion_tpu.models.single_level import solve_single_level as jsolve
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch.models import params as tparams
from levelsetfusion_tpu_torch.models.single_level import solve_single_level as tsolve
from tests.torch_parity import assert_close, n, t, tsdf_like

CONFIG3 = dict(
    learning_rate=0.5, smoothing_term_weight=0.1,
    smoothing_mode="KILLING", rigidity_enforcement_factor=0.1,
    level_set_term_weight=0.1, sobolev_smoothing=True, adaptive_learning_rate=True,
)


def _params(**kw):
    kw = {**CONFIG3, **kw}
    mode = kw.pop("smoothing_mode")
    return (jparams.SolverParams(smoothing_mode=jparams.SmoothingMode[mode], **kw),
            tparams.SolverParams(smoothing_mode=tparams.SmoothingMode[mode], **kw))


def _compare(got, want, max_iterations):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.warp.shape == want.warp.shape
    assert_close(got.warp, want.warp, rtol=3e-4, atol=3e-6)
    assert_close(got.max_abs_displacement, want.max_abs_displacement, rtol=3e-4, atol=3e-6)
    for name in want.telemetry._fields:
        a, b = getattr(got.telemetry, name), getattr(want.telemetry, name)
        assert a.shape == (max_iterations,)
        assert_close(a, b, rtol=2e-4, atol=1e-8)
        assert not np.any(n(a)[got.iterations:])


@pytest.mark.parametrize(
    "case",
    [
        dict(max_iterations=12, convergence_threshold=0.0),  # the config3 energy
        dict(max_iterations=10, convergence_threshold=0.0, smoothing_mode="TIKHONOV",
             smoothing_term_weight=0.2, level_set_term_weight=0.0,
             sobolev_smoothing=False, adaptive_learning_rate=False, learning_rate=0.3),
        dict(max_iterations=8, convergence_threshold=0.0, level_set_term_weight=0.0,
             sobolev_smoothing=False, adaptive_learning_rate=False),
    ],
)
def test_matches_jax_golden_solve(case):
    canonical, live, _ = tsdf_like((12, 10, 8), 30)
    jp, tp = _params(**case)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp)
    got = tsolve(t(canonical), t(live), tp)
    _compare(got, want, case["max_iterations"])


def test_warm_start_and_early_stop_match_jax():
    """A warm start (which seeds max_abs_displacement) and a threshold that
    stops the loop before the iteration cap."""
    canonical, live, warp = tsdf_like((12, 10, 8), 31, warp_scale=0.3)
    jp, tp = _params(max_iterations=60, convergence_threshold=0.03)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp, jnp.asarray(warp))
    got = tsolve(t(canonical), t(live), tp, t(warp))
    assert got.converged and 0 < got.iterations < 60
    _compare(got, want, 60)


def test_matches_jax_fused_pallas_solve():
    """Against the JAX solve that runs both Pallas kernels (interpret mode)
    at (16, 16, 128), the shape the TPU kernels take."""
    canonical, live, _ = tsdf_like((16, 16, 128), 32)
    jp, tp = _params(max_iterations=6, convergence_threshold=0.0, learning_rate=0.3)
    jp = jp.replace(use_pallas_resample=True, use_pallas_gradient=True,
                    pallas_interpret=True)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp)
    got = tsolve(t(canonical), t(live), tp)
    _compare(got, want, 6)


def test_zero_iterations():
    """No iteration runs: not converged, zero telemetry, and the per-axis
    max |u| of the warm start."""
    _, _, warp = tsdf_like((5, 4, 3), 33)
    res = tsolve(torch.zeros(5, 4, 3), torch.zeros(5, 4, 3),
                 tparams.SolverParams(max_iterations=0), t(warp))
    assert res.iterations == 0 and res.converged is False
    assert all(b.shape == (0,) for b in res.telemetry)
    np.testing.assert_array_equal(n(res.max_abs_displacement),
                                  np.abs(warp).max(axis=(0, 1, 2)))
    np.testing.assert_array_equal(n(res.warp), warp)


def test_2d_solve_not_ported_raises():
    with pytest.raises(NotImplementedError, match="A8"):
        tsolve(torch.zeros(8, 8), torch.zeros(8, 8))


def test_solver_params_from_jax_drops_tpu_fields():
    for name, cfg in JPRESETS.items():
        d = dataclasses.asdict(cfg.solver)
        got = tparams.solver_params_from_jax(d)
        for f in dataclasses.fields(got):
            want = d[f.name]
            have = getattr(got, f.name)
            assert getattr(have, "value", have) == getattr(want, "value", want), (name, f.name)
        for field in tparams.JAX_ONLY_FIELDS:
            assert not hasattr(got, field)
    # config.json form: the enum as its string value
    d = {**dataclasses.asdict(JPRESETS["config3_3d_full_energy"].solver),
         "smoothing_mode": "killing"}
    assert tparams.solver_params_from_jax(d).smoothing_mode is tparams.SmoothingMode.KILLING
