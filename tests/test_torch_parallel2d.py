"""Parity of the port's 2D-mesh sync solver (``parallel/sharded2d.py``),
its Schur-2D solver and the CLI's 2D-mesh presets with the JAX package's,
on gloo ranks spawned by ``tests/torch_ranks.py`` (one spawn per mesh
shape, (2, 4) and (4, 2), each carrying every case of its shape; the JAX
side runs in the test process on the virtual CPU mesh of the same shape
and hands its inputs over as numpy arrays).

- tests/test_parallel2d.py's ``_parity`` cases (Tikhonov, Sobolev, Killing
  + level set + adaptive rate on (2, 4) at (16, 16, 12); Sobolev on (4, 2)
  at (16, 8, 12), whose 4 x 4 blocks are thinner than the stencil halo of
  5, so the halos come from two ranks away) against JAX's
  ``solve_single_level_sharded2d`` at that test's tolerances: the
  iteration count exactly, the warp atol 2e-5 rtol 1e-4, the telemetry
  atol 1e-4 rtol 2e-4.
- ``warp_field_sharded2d`` against the single-device resample (atol 1e-6)
  and JAX's, with displacements up to 3 across the block faces.
- ``solve_single_level_schur2d`` on (2, 4) against JAX's (the Killing +
  level set + Sobolev case of tests/test_schur2d.py with the fused kernel,
  and Tikhonov): the outer steps exactly, the warp atol 3e-5 rtol 1e-4,
  the per-outer-step telemetry atol 1e-4 rtol 3e-4 (tests/test_schur.py's).
- The reductions along each mesh axis and over both, and the two-axis
  exchange's corners (from the diagonal neighbour).
- config5_2dmesh and config5_schur2d through both CLIs on (2, 4), shrunk:
  iterations or outer steps, ``converged``, residuals rtol 1e-4, max |u|
  rtol 3e-4, JAX's summary keys.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.models.params import SmoothingMode as JMode
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.ops.interpolation import warp_field as jwarp_field
from levelsetfusion_tpu.parallel import halo as jhalo
from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
from levelsetfusion_tpu.parallel.schur2d import solve_single_level_schur2d
from levelsetfusion_tpu.parallel.sharded2d import (
    solve_single_level_sharded2d,
    warp_field_sharded2d,
)
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch.models.params import solver_params_from_jax
from levelsetfusion_tpu_torch.utils.config import PRESETS
from tests.test_schur import _sphere
from tests.torch_ranks import run_ranks

TEL = ("data_energy", "smoothing_energy", "level_set_energy", "max_warp_update",
       "mean_warp_update")


def _fields(shape):
    """tests/test_parallel2d.py's sphere pair."""
    c = [s / 2.0 for s in shape]
    return (np.asarray(_sphere(shape, c)),
            np.asarray(_sphere(shape, [c[0] + 0.6, c[1] + 0.4, c[2]])))


SYNC = {
    "tikhonov": ((2, 4), (16, 16, 12), JSolver(max_iterations=20, learning_rate=0.3)),
    "sobolev": ((2, 4), (16, 16, 12), JSolver(max_iterations=15, learning_rate=0.3,
                                              sobolev_smoothing=True)),
    "killing_levelset": ((2, 4), (16, 16, 12), JSolver(
        max_iterations=15, learning_rate=0.3, smoothing_mode=JMode.KILLING,
        level_set_term_weight=0.1, sobolev_smoothing=True, adaptive_learning_rate=True)),
    "4x2_uneven": ((4, 2), (16, 8, 12), JSolver(max_iterations=10, learning_rate=0.3,
                                               sobolev_smoothing=True)),
}
SCHUR2D_BASE = JSolver(learning_rate=0.3, max_iterations=16, convergence_threshold=0.0,
                       smoothing_term_weight=0.2, sobolev_smoothing=True)
SCHUR2D = {
    # tests/test_schur2d.py::test_schur2d_fused_path_matches_jnp_path's case,
    # JAX's fused kernel in interpret mode (its y window and conv_local_x).
    "killing_levelset_fused": ((16, 32, 128), SCHUR2D_BASE.replace(
        smoothing_mode=JMode.KILLING, level_set_term_weight=0.1, use_pallas_gradient=True,
        pallas_interpret=True)),
    "tikhonov": ((16, 16, 16), SCHUR2D_BASE.replace(sobolev_smoothing=False,
                                                    max_iterations=24)),
}
CLI_SMALL = dict(grid_shape=(16, 16, 16), grid_offset=(-8, -8, 38), live_halo=4)


def _cli_config(presets, name):
    """tests/test_parallel2d.py::test_cli_sharded_mode_2d_mesh's shrink."""
    cfg = dataclasses.replace(presets[name], **CLI_SMALL)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=16))


def _warp_inputs():
    rng = np.random.default_rng(5)
    live = np.tanh(rng.standard_normal((16, 16, 12))).astype(np.float32)
    warp = rng.uniform(-3, 3, (16, 16, 12, 3)).astype(np.float32)
    return live, warp


def _ramp():
    x = np.arange(16, dtype=np.float32)[:, None, None] * 100
    y = np.arange(16, dtype=np.float32)[None, :, None]
    return (x + y + np.zeros((1, 1, 3), np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (JAX's result, rank 0's result, every rank's)}``, one spawn
    per mesh shape."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    jax_side, cases = {}, {(2, 4): [], (4, 2): []}
    for name, (shape, grid, params) in SYNC.items():
        c, l = _fields(grid)
        jax_side[name] = solve_single_level_sharded2d(
            jnp.asarray(c), jnp.asarray(l), params, mesh=make_mesh_2d(shape), live_halo=8)
        cases[shape].append((name, ("solve", dict(
            solver="sharded2d", canonical=c, live=l, params=solver_params_from_jax(params),
            kw=dict(live_halo=8)))))
    for name, (grid, params) in SCHUR2D.items():
        c, l = _fields(grid)
        jax_side["schur2d_" + name] = solve_single_level_schur2d(
            jnp.asarray(c), jnp.asarray(l), params, mesh=make_mesh_2d((2, 4)),
            inner_iterations=4, live_halo=8)
        cases[2, 4].append(("schur2d_" + name, ("solve", dict(
            solver="schur2d", canonical=c, live=l, params=solver_params_from_jax(params),
            kw=dict(live_halo=8, inner_iterations=4)))))
    live, warp = _warp_inputs()
    for lh in (4, 8):
        jax_side[f"warp2d_{lh}"] = warp_field_sharded2d(
            jnp.asarray(live), jnp.asarray(warp), mesh=make_mesh_2d((2, 4)), live_halo=lh)
        cases[2, 4].append((f"warp2d_{lh}", ("warp2d", dict(live=live, warp=warp,
                                                          live_halo=lh))))
    for shape in cases:
        cases[shape].append(("reduce", ("reduce", dict(field=_ramp(), width=2,
                                                       fill="truncation"))))
    for name in ("config5_2dmesh", "config5_schur2d"):
        jax_side[name] = jrun(_cli_config(JPRESETS, name), str(tmp / f"jax_{name}"))
        cases[2, 4].append((name, ("cli", (_cli_config(PRESETS, name),
                                           str(tmp / f"port_{name}")))))
    out = {}
    for shape, named in cases.items():
        ranks = run_ranks("tests.torch_ranks.mesh_cases", shape[0] * shape[1],
                          tmp_path_factory.mktemp(f"ranks_{shape[0]}x{shape[1]}"),
                          {"mesh": shape, "cases": [c for _, c in named]})
        for i, (name, _) in enumerate(named):
            out[name if name != "reduce" else f"reduce_{shape[0]}x{shape[1]}"] = (
                jax_side.get(name), ranks[0][i], [r[i] for r in ranks])
    return out


def _check_solve(jres, ranks, warp_tol, tel_tol):
    warp, its, converged, tel, md = ranks[0]
    assert {r[1] for r in ranks} == {int(jres.iterations)}, (its, int(jres.iterations))
    assert {r[2] for r in ranks} == {bool(jres.converged)}
    np.testing.assert_allclose(warp, np.asarray(jres.warp), **warp_tol)
    n = int(jres.iterations)
    for r in ranks:
        for name, got in zip(TEL, r[3]):
            want = np.asarray(getattr(jres.telemetry, name))
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got[:n], want[:n], **tel_tol, err_msg=name)
            assert not got[n:].any()
        np.testing.assert_allclose(r[4], np.asarray(jres.max_abs_displacement), rtol=3e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("case", list(SYNC))
def test_sync_2d_matches_jax(case, runs):
    jres, _, ranks = runs[case]
    _check_solve(jres, ranks, dict(atol=2e-5, rtol=1e-4), dict(atol=1e-4, rtol=2e-4))


@pytest.mark.parametrize("case", list(SCHUR2D))
def test_schur2d_matches_jax(case, runs):
    jres, _, ranks = runs["schur2d_" + case]
    assert jres.inner_per_outer == 4
    _check_solve(jres, ranks, dict(atol=3e-5, rtol=1e-4), dict(atol=1e-4, rtol=3e-4))


@pytest.mark.parametrize("live_halo", [4, 8])
def test_warp_field_sharded2d(live_halo, runs):
    """The blend's gather on (2, 4): JAX's sharded one, and within the halo
    contract (|u| <= 3 <= live_halo - 1 reaches no +1 fill) the whole-volume
    resample."""
    want, got, _ = runs[f"warp2d_{live_halo}"]
    live, warp = _warp_inputs()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    whole = np.asarray(jwarp_field(jnp.asarray(live), jnp.asarray(warp)))
    np.testing.assert_allclose(got, whole, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_mesh_axes_reductions_and_corners(shape, runs):
    """psum/pmax along mesh axis 0 sum the ranks of a column, along axis 1
    those of a row, over the mesh all; the two-axis exchange matches JAX's
    ``exch2`` (corners from the diagonal neighbour, +1 past the volume)."""
    _, _, ranks = runs[f"reduce_{shape[0]}x{shape[1]}"]
    s0, s1 = shape
    field = _ramp()

    def exch2(blk):
        blk = jhalo.halo_exchange(blk, 2, "x", s0, fill="truncation", axis=0)
        return jhalo.halo_exchange(blk, 2, "y", s1, fill="truncation", axis=1)

    want = np.asarray(shard_map(exch2, mesh=make_mesh_2d(shape), in_specs=(P("x", "y"),),
                                out_specs=P("x", "y"), check_vma=False)(jnp.asarray(field)))
    n0, n1 = 16 // s0 + 4, 16 // s1 + 4
    for rank, (reduced, ext, (i0, i1)) in enumerate(ranks):
        assert (i0, i1) == divmod(rank, s1)
        column = [i * s1 + i1 for i in range(s0)]
        row = [i0 * s1 + j for j in range(s1)]
        assert [float(v[0]) for v in reduced["sum"]] == [sum(column), sum(row),
                                                         sum(range(s0 * s1))]
        assert [float(v[0]) for v in reduced["max"]] == [max(column), max(row), s0 * s1 - 1]
        np.testing.assert_array_equal(ext, want[i0 * n0:(i0 + 1) * n0, i1 * n1:(i1 + 1) * n1])


@pytest.mark.parametrize("name", ["config5_2dmesh", "config5_schur2d"])
def test_cli_2d_mesh_presets_match_jax(name, runs):
    jsum, tsum, ranks = runs[name]
    assert set(jsum) - {"fast_paths"} <= set(tsum)
    assert tsum["devices"] == jsum["devices"] == 8
    for key in ("iterations", "converged", "contract_violations", "solver_kind",
                "outer_steps", "inner_per_outer", "total_inner_iterations"):
        assert tsum.get(key) == jsum.get(key), key
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
    assert all(r["iterations"] == tsum["iterations"] for r in ranks)
