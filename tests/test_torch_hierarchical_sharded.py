"""Parity of the port's hierarchical sharded solve
(``parallel/hierarchical.py``), its hierarchical and 2D-mesh sharded fusion
(``models/fusion.py::fuse_sequence_sharded``), 2D-mesh checkpoints and the
CLI's ``hierarchical_sharded_3d`` and 2D-mesh ``multi_frame_sharded_3d``
with the JAX package's, on gloo ranks spawned by ``tests/torch_ranks.py``:
one spawn of 4 ranks on the 1D mesh and one on a (2, 2) mesh, each
carrying every case of its mesh; the JAX side runs in the test process on
the virtual CPU mesh of the same shape.

- tests/test_hierarchical_sharded.py's cases against JAX's
  ``solve_hierarchical_sharded``: the 2D pair over 3 levels (the coarsest
  too thin to shard, so replicated), its warm start, and the 2D-mesh case
  at (32, 32, 16): per-level iterations and halos exactly, the warp atol
  2e-5 rtol 1e-4, each level's data energy atol 1e-4 rtol 2e-4.
- tests/test_fusion_sharded.py's hierarchical (1D, 4 ranks) and 2D-mesh
  ((2, 2)) fusion against JAX's: per-frame iterations exactly, the
  canonical atol 5e-5 rtol 1e-4 (hierarchical) and atol 2e-5 (2D mesh),
  the weights atol 1e-5.
- A checkpoint of 2D blocks (JAX's shard layout: each shard's index along
  axes 0 and 1), read whole and as each rank's block.
- config5_hierarchical (on 4 ranks and on (2, 2)) and the 2D-mesh
  ``multi_frame_sharded_3d`` through both CLIs, shrunk: per-level
  iterations and halos, residuals rtol 1e-4, per-frame iterations.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import synthetic as jsynthetic
from levelsetfusion_tpu.models import fusion as jfusion
from levelsetfusion_tpu.models.params import HierarchicalParams as JHier
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.parallel import make_mesh
from levelsetfusion_tpu.parallel.hierarchical import solve_hierarchical_sharded
from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models.fusion import FusionPipelineConfig
from levelsetfusion_tpu_torch.models.params import HierarchicalParams, solver_params_from_jax
from levelsetfusion_tpu_torch.utils import checkpoint
from levelsetfusion_tpu_torch.utils.config import PRESETS
from tests.test_single_level import make_pair_fields
from tests.torch_ranks import run_ranks

SEQ = dict(width=32, height=32, blob_radius_px=6.0, blob_height=0.05,
           drift_px_per_frame=(1.0, 0.0), pulse_amplitude=0.05)
GRID = dict(shape=(16, 16, 16), voxel_size=0.01, offset=(-8, -8, 30))
FUSION_SOLVER = dict(max_iterations=12, learning_rate=0.3, smoothing_term_weight=0.1,
                     convergence_threshold=1e-3)


def _pair():
    return tuple(np.asarray(a) for a in make_pair_fields()[:2])


def _mesh_fields():
    """tests/test_hierarchical_sharded.py's 2D-mesh case's fields."""
    base = np.random.default_rng(0).standard_normal((32, 32, 16)).astype(np.float32)
    return np.tanh(base * 0.4), np.tanh(np.roll(base, 1, axis=0) * 0.4)


# name -> (mesh, fields, JAX params, keyword arguments, warm start)
HIER = {
    "pair_2d": (None, _pair, JHier(levels=3, base=JSolver(
        max_iterations=20, convergence_threshold=0.0, sobolev_smoothing=True,
        learning_rate=0.5)), {}, False),
    "warm_start": (None, _pair, JHier(levels=2, base=JSolver(
        max_iterations=10, convergence_threshold=0.0)), {}, True),
    "mesh_2x2": ((2, 2), _mesh_fields, JHier(levels=2, base=JSolver(
        max_iterations=8, convergence_threshold=0.0, learning_rate=0.3)),
        {"min_live_halo": 4}, False),
}


def _fusion_config(hierarchical, fusion_cls, grid_cls, solver):
    return fusion_cls(grid=grid_cls(**GRID), hierarchical=hierarchical, levels=2,
                      solver=solver)


def _hier_cli(presets, mesh_shape):
    cfg = dataclasses.replace(presets["config5_hierarchical"], grid_shape=(64, 24, 16),
                              grid_offset=(-32, -12, 38), num_devices=4, mesh_shape=mesh_shape)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=30))


def _fusion_cli(presets):
    """tests/test_fusion_sharded.py::test_cli_multi_frame_sharded_mode's run
    on the (2, 2) mesh."""
    cfg = dataclasses.replace(
        presets["config4_3d_fusion"], name="sharded_fusion_2d", mode="multi_frame_sharded_3d",
        grid_shape=GRID["shape"], voxel_size=GRID["voxel_size"], grid_offset=GRID["offset"],
        num_frames=3, mesh_shape=(2, 2), live_halo=4, checkpoint_every=1,
        dataset_kwargs={"width": 32, "height": 32, "blob_radius_px": 6.0})
    return dataclasses.replace(cfg, solver=cfg.solver.replace(
        max_iterations=8, learning_rate=0.3, smoothing_term_weight=0.1,
        convergence_threshold=1e-3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (JAX's result, every rank's)}``, one spawn per mesh."""
    tmp = tmp_path_factory.mktemp("hier")
    jax_side, cases = {}, {None: [], (2, 2): []}
    for name, (shape, fields, hp, kw, warm) in HIER.items():
        c, l = fields()
        w0 = np.full(c.shape + (c.ndim,), 0.25, np.float32) if warm else None
        mesh = make_mesh(4) if shape is None else make_mesh_2d(shape)
        axes = {} if shape is None else {"mesh_axes": ("x", "y")}
        jax_side[name] = solve_hierarchical_sharded(
            jnp.asarray(c), jnp.asarray(l), hp, mesh=mesh, **axes, **kw,
            initial_warp=None if w0 is None else jnp.asarray(w0))
        cases[shape].append((name, ("hierarchical", dict(
            canonical=c, live=l, kw=kw,
            params=HierarchicalParams(levels=hp.levels, base=solver_params_from_jax(hp.base)),
            initial_warp=w0))))
    seq = jsynthetic.snoopy_style_sequence_3d(3, **SEQ)
    pseq = synthetic.snoopy_style_sequence_3d(3, **SEQ)
    for name, shape, hierarchical, halo in (("fusion_hierarchical", None, True, 8),
                                            ("fusion_2d_mesh", (2, 2), False, 4)):
        jcfg = _fusion_config(hierarchical, jfusion.FusionPipelineConfig, JGrid,
                              JSolver(**FUSION_SOLVER))
        mesh = make_mesh(4) if shape is None else make_mesh_2d(shape)
        jax_side[name] = jfusion.fuse_sequence_sharded(
            seq.frames, seq.camera, jcfg, mesh=mesh, live_halo=halo,
            **({} if shape is None else {"mesh_axes": ("x", "y")}))
        pcfg = _fusion_config(hierarchical, FusionPipelineConfig, GridSpec,
                              solver_params_from_jax(jcfg.solver))
        cases[shape].append((name, ("fusion", (list(pseq.frames), pseq.camera, pcfg, halo))))
    for shape in cases:
        tag = "1d" if shape is None else "2x2"
        jax_side[f"cli_hierarchical_{tag}"] = jrun(_hier_cli(JPRESETS, shape),
                                                   str(tmp / f"jax_hier_{tag}"))
        cases[shape].append((f"cli_hierarchical_{tag}", ("cli", (
            _hier_cli(PRESETS, shape), str(tmp / f"port_hier_{tag}")))))
    jax_side["cli_fusion_2x2"] = jrun(_fusion_cli(JPRESETS), str(tmp / "jax_fusion"))
    cases[2, 2].append(("cli_fusion_2x2", ("cli", (_fusion_cli(PRESETS),
                                                    str(tmp / "port_fusion")))))
    rng = np.random.default_rng(12)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((8, 6, 4), (8, 6, 4),
                                                                 (8, 6, 4, 3))]
    cases[2, 2].append(("checkpoint", ("checkpoint", (str(tmp / "ckpt2d"), arrays))))
    jax_side["checkpoint"] = arrays
    out = {}
    for shape, named in cases.items():
        ranks = run_ranks("tests.torch_ranks.mesh_cases", 4, tmp_path_factory.mktemp("ranks"),
                          {"mesh": shape, "cases": [c for _, c in named]})
        for i, (name, _) in enumerate(named):
            out[name] = (jax_side[name], [r[i] for r in ranks])
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("case", list(HIER))
def test_hierarchical_sharded_matches_jax(case, runs):
    jres, ranks = runs[case]
    warp, its, halos, energies = ranks[0]
    assert all(r[1] == its and r[2] == halos for r in ranks)
    assert its == [int(r.iterations) for r in jres.level_results]
    assert halos == tuple(jres.level_halos)
    np.testing.assert_allclose(warp, np.asarray(jres.warp), atol=2e-5, rtol=1e-4)
    for lvl, (got, want) in enumerate(zip(energies, jres.level_results)):
        n = its[lvl]
        np.testing.assert_allclose(got[:n], np.asarray(want.telemetry.data_energy)[:n],
                                   atol=1e-4, rtol=2e-4, err_msg=f"level {lvl}")
    if case == "mesh_2x2":
        assert halos[-1] is not None


@pytest.mark.parametrize("case,canonical_atol", [("fusion_hierarchical", 5e-5),
                                                 ("fusion_2d_mesh", 2e-5)])
def test_sharded_fusion_matches_jax(case, canonical_atol, runs):
    jres, ranks = runs[case]
    (canonical, weights, warp), reports = ranks[0]
    np.testing.assert_allclose(canonical, np.asarray(jres.state.canonical),
                               atol=canonical_atol, rtol=1e-4)
    np.testing.assert_allclose(weights, np.asarray(jres.state.weights), atol=1e-5)
    assert [r["solver_iterations"] for r in reports] == [
        r.solver_iterations for r in jres.reports]
    for got, want in zip(reports, jres.reports):
        assert list(got["contract_violations"]) == list(want.contract_violations) == []
        np.testing.assert_allclose(got["max_abs_displacement"], want.max_abs_displacement,
                                   rtol=3e-4, atol=1e-6)
    assert all(r[1] == reports for r in ranks)


def test_checkpoint_of_2d_blocks(runs):
    """Each rank wrote its (4, 3) block of (8, 6, ...): read whole, and as
    each rank's block, in JAX's meta layout."""
    arrays, ranks = runs["checkpoint"]
    for rank, (full, mine, blocks, meta) in enumerate(ranks):
        for a, b in zip(full, arrays):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(mine, blocks):
            np.testing.assert_array_equal(a, b)
        i0, i1 = divmod(rank, 2)
        np.testing.assert_array_equal(blocks[2], arrays[2][4 * i0:4 * i0 + 4,
                                                          3 * i1:3 * i1 + 3])
    info = ranks[0][3]["arrays"]["warp"]
    assert info["sharded"] and info["shape"] == [8, 6, 4, 3]
    assert [s["index"][:2] for s in info["shards"]] == [
        [[0, 4], [0, 3]], [[0, 4], [3, 6]], [[4, 8], [0, 3]], [[4, 8], [3, 6]]]


@pytest.mark.parametrize("tag", ["1d", "2x2"])
def test_cli_hierarchical_sharded_matches_jax(tag, runs):
    jsum, ranks = runs[f"cli_hierarchical_{tag}"]
    tsum = ranks[0]
    assert set(jsum) - {"fast_paths"} <= set(tsum)
    assert tsum["devices"] == jsum["devices"] == 4
    for key in ("levels", "iterations_per_level", "level_live_halos", "converged",
                "contract_violations"):
        assert tsum[key] == jsum[key], key
    assert tsum["level_live_halos"][-1] is not None  # the finest level ran sharded
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)


def test_cli_multi_frame_sharded_2d_mesh(runs):
    jsum, ranks = runs["cli_fusion_2x2"]
    tsum, out = ranks[0], str(runs["tmp"] / "port_fusion")
    assert tsum["frames"] == jsum["frames"] == 3
    assert tsum["devices"] == jsum["devices"] == 4
    assert set(jsum) - {"fast_paths", "final_pallas_max_displacement"} <= set(tsum)
    assert [r["solver_iterations"] for r in tsum["reports"]] == [
        r["solver_iterations"] for r in jsum["reports"]]
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["frames_per_s"] > 0
    state, warp, meta = checkpoint.load(os.path.join(out, "checkpoints"))
    assert meta["frame"] == 2 and meta["arrays"]["warp"]["sharded"]
    assert len(meta["arrays"]["warp"]["shards"]) == 4
    assert warp.shape == (16, 16, 16, 3) and state.canonical.shape == (16, 16, 16)
