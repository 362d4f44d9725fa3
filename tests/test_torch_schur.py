"""Parity of the port's Schur solver (``parallel/schur.py``) and the CLI's
config5_sharded_schur with the JAX package's, on 4 gloo ranks spawned by
``tests/torch_ranks.py`` (one spawn carrying every case; the JAX side runs
in the test process on 4 devices of the virtual CPU mesh).

- tests/test_schur.py's cases against JAX's ``solve_single_level_schur``:
  its telemetry-schema case (4 outer steps of 8), its fused-kernel case
  with JAX's fused kernel in interpret mode (``conv_local_x``: Sobolev and
  level set, (32, 8, 128)), a Killing case with the adaptive rate (the
  interface coupling of component 0), and its converging case (threshold
  5e-4). The outer steps exactly, the warp atol 3e-5 rtol 1e-4, the
  per-outer-step telemetry atol 1e-4 rtol 3e-4 (tests/test_schur.py's).
- A world of 1 in the test process: ``T`` inner iterations and no cut,
  the single-device solve's warp after the same iterations (atol 2e-5
  rtol 1e-4).
- config5_sharded_schur through both CLIs on 4 ranks, shrunk: outer steps,
  ``converged``, residuals rtol 1e-4, max |u| rtol 3e-4, JAX's summary
  keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.models.params import SmoothingMode as JMode
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.parallel.schur import solve_single_level_schur
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch.models.params import solver_params_from_jax
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.parallel import schur as tschur
from levelsetfusion_tpu_torch.parallel.mesh import close_group, init_group
from levelsetfusion_tpu_torch.utils.config import PRESETS
from tests.test_schur import PARAMS, _fields
from tests.test_torch_parallel2d import _check_solve
from tests.torch_ranks import run_ranks


def _fused_fields():
    """tests/test_schur.py::test_schur_fused_kernel_matches_jnp_inner's."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((32, 8, 128)).astype(np.float32)
    return np.tanh(base * 0.3), np.tanh(np.roll(base, 1, axis=0) * 0.3)


# name -> (fields, JAX params, inner iterations)
CASES = {
    "schema": ("sphere", PARAMS.replace(max_iterations=32, convergence_threshold=0.0), 8),
    "fused_kernel": ("fused", JSolver(
        learning_rate=0.2, max_iterations=24, convergence_threshold=0.0,
        smoothing_term_weight=0.1, level_set_term_weight=0.1, sobolev_smoothing=True,
        use_pallas_gradient=True, pallas_interpret=True), 4),
    "killing_adaptive": ("sphere", PARAMS.replace(
        max_iterations=40, convergence_threshold=0.0, smoothing_mode=JMode.KILLING,
        adaptive_learning_rate=True, learning_rate=0.5), 4),
    "converging": ("sphere", PARAMS, 8),
}
CLI_SMALL = dict(grid_shape=(32, 24, 16), grid_offset=(-16, -12, 38), num_devices=4)


def _cli_config(presets):
    cfg = dataclasses.replace(presets["config5_sharded_schur"], **CLI_SMALL)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=24))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("schur")
    fields = {"sphere": tuple(np.asarray(a) for a in _fields(None)),
              "fused": _fused_fields()}
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    jax_side, cases = {}, []
    for name, (key, params, t) in CASES.items():
        c, l = fields[key]
        jax_side[name] = solve_single_level_schur(jnp.asarray(c), jnp.asarray(l), params,
                                                  mesh=mesh, inner_iterations=t)
        cases.append(("solve", dict(solver="schur", canonical=c, live=l,
                                    params=solver_params_from_jax(params),
                                    kw=dict(inner_iterations=t))))
    jax_side["cli"] = jrun(_cli_config(JPRESETS), str(tmp / "jax_cli"))
    cases.append(("cli", (_cli_config(PRESETS), str(tmp / "port_cli"))))
    ranks = run_ranks("tests.torch_ranks.mesh_cases", 4, tmp, {"cases": cases})
    names = [*CASES, "cli"]
    return {name: (jax_side[name], [r[i] for r in ranks]) for i, name in enumerate(names)}


@pytest.mark.parametrize("case", list(CASES))
def test_schur_matches_jax(case, runs):
    jres, ranks = runs[case]
    assert jres.inner_per_outer == CASES[case][2]
    _check_solve(jres, ranks, dict(atol=3e-5, rtol=1e-4), dict(atol=1e-4, rtol=3e-4))
    if case == "schema":
        assert ranks[0][1] == 4
    if case == "converging":
        assert ranks[0][2] and ranks[0][1] < -(-PARAMS.max_iterations // 8)


def test_world_of_one_is_the_single_device_solve():
    """No cut: the block-local filter is the volume's and the interface
    solve keeps both edges' explicit update, so T inner iterations an outer
    step give the single-device solve's warp after as many iterations."""
    c, l = (torch.from_numpy(np.array(a)) for a in _fields(None))
    params = solver_params_from_jax(PARAMS.replace(max_iterations=24,
                                                   convergence_threshold=0.0))
    want = solve_single_level(c, l, params)
    group = init_group("cpu")
    try:
        got = tschur.solve_single_level_schur(c, l, params, group=group, inner_iterations=8)
    finally:
        close_group(group)
    assert got.outer_steps == 3 and got.iterations == 3 and want.iterations == 24
    np.testing.assert_allclose(got.warp, want.warp, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.telemetry.max_warp_update[-1],
                               want.telemetry.max_warp_update[-1], rtol=1e-4)


def test_cli_schur_preset_matches_jax(runs):
    jsum, ranks = runs["cli"]
    tsum = ranks[0]
    assert set(jsum) - {"fast_paths"} <= set(tsum)
    assert tsum["devices"] == jsum["devices"] == 4
    for key in ("iterations", "converged", "contract_violations", "solver_kind",
                "outer_steps", "inner_per_outer", "total_inner_iterations"):
        assert tsum[key] == jsum[key], key
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
