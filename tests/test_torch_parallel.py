"""Parity of the port's 1D sharded solver (``parallel/sharded.py``), its
sharded fusion, sharded checkpoints and sharded CLI modes with the JAX
package's, on gloo ranks spawned by ``tests/torch_ranks.py`` (one spawn of
4 ranks and one of 8; the JAX side runs in the test process on the virtual
CPU mesh and hands its inputs over as numpy arrays).

- The ``_parity`` cases of tests/test_parallel.py (Tikhonov, + Sobolev,
  Killing + level set, 8 ranks, 3D) against JAX's
  ``solve_single_level_sharded`` at that test's tolerances: the iteration
  count exactly, the warp atol 2e-5 rtol 1e-4, the telemetry atol 1e-4
  rtol 2e-4.
- A world of 1 in the test process against the single-device port: equal
  with no live halo, within rounding with one.
- Its termination-interval test, with the adaptive rate off and on: the
  port at k = 1 and k = 4 against JAX's at the same k, and JAX's rules
  between the two runs.
- tests/test_fusion_sharded.py's fusion and CLI cases (canonical atol 2e-5
  rtol 1e-4, weights atol 1e-5, per-frame iterations exactly), a sharded
  checkpoint's round trip, and a checkpoint that JAX wrote sharded read by
  the port, whole and as each rank's block; the hierarchical and 2D-mesh
  sharded fusion on a world of 1 against JAX's on one device; the
  live-halo contract's messages are JAX's.
- ``sharded_3d`` through the CLI on a world of 1 against JAX's CLI on 4
  devices (iterations, ``converged``, residuals rtol 1e-4, max |u| rtol
  3e-4, telemetry rows rtol 2e-4 atol 1e-8, JAX's summary keys).
"""

import csv
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.core.camera import PinholeCamera as JCamera
from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import synthetic as jsynthetic
from levelsetfusion_tpu.models import fusion as jfusion
from levelsetfusion_tpu.models.params import SmoothingMode as JMode
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d as jtsdf
from levelsetfusion_tpu.parallel import make_mesh, solve_single_level_sharded
from levelsetfusion_tpu.parallel.mesh import make_mesh_2d
from levelsetfusion_tpu.utils import checkpoint as jcheckpoint
from levelsetfusion_tpu.utils import debug as jdebug
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch import cli as tcli
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models.fusion import FusionPipelineConfig, fuse_sequence_sharded
from levelsetfusion_tpu_torch.models.params import solver_params_from_jax
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.parallel import sharded as tsharded
from levelsetfusion_tpu_torch.parallel.mesh import close_group, init_group
from levelsetfusion_tpu_torch.parallel.mesh import make_mesh_2d as tmake_mesh_2d
from levelsetfusion_tpu_torch.utils import checkpoint
from levelsetfusion_tpu_torch.utils.config import PRESETS
from levelsetfusion_tpu_torch.utils.debug import check_displacement_contract
from tests.test_single_level import make_pair_fields
from tests.torch_ranks import run_ranks

TEL = ("data_energy", "smoothing_energy", "level_set_energy", "max_warp_update",
       "mean_warp_update")


def _fields_3d():
    """tests/test_parallel.py::test_parity_3d's pair."""
    cam = JCamera(fx=48.0, fy=48.0, cx=24.0, cy=24.0, image_width=48, image_height=48)
    grid = JGrid(shape=(32, 32, 24), voxel_size=0.008, offset=(-16, -16, 42))
    c_depth = jsynthetic.blob_wall_depth_3d(cam, blob_radius_px=10.0, blob_height=0.06)
    l_depth = jsynthetic.blob_wall_depth_3d(
        cam, blob_center_px=(26.0, 24.0), blob_radius_px=10.0, blob_height=0.06)
    return jtsdf(jnp.asarray(c_depth), cam, grid), jtsdf(jnp.asarray(l_depth), cam, grid)


def _termination_fields():
    """tests/test_parallel.py::test_termination_check_interval_semantics's."""
    rng = np.random.default_rng(3)
    c = np.tanh(rng.standard_normal((32, 16, 32)).astype(np.float32) * 0.3)
    return c, np.roll(c, 1, 0)


TERMINATION = dict(max_iterations=24, learning_rate=0.2, smoothing_term_weight=0.1,
                   sobolev_smoothing=True, convergence_threshold=3.5e-2)

# name -> (fields, JAX params, live_halo, ranks); tests/test_parallel.py's cases.
CASES = {
    "tikhonov": ("pair", JSolver(max_iterations=40, learning_rate=1.0), 8, 4),
    "tikhonov_sobolev": ("pair", JSolver(max_iterations=30, learning_rate=1.0,
                                         sobolev_smoothing=True), 8, 4),
    "killing_levelset": ("pair", JSolver(max_iterations=25, learning_rate=0.5,
                                         smoothing_mode=JMode.KILLING,
                                         level_set_term_weight=0.1), 8, 4),
    "3d": ("3d", JSolver(max_iterations=25, learning_rate=0.5, smoothing_term_weight=0.1,
                         smoothing_mode=JMode.KILLING), 8, 4),
    "k1": ("termination", JSolver(**TERMINATION), 8, 4),
    "k4": ("termination", JSolver(**TERMINATION, termination_check_interval=4), 8, 4),
    "k1_adaptive": ("termination", JSolver(**TERMINATION, adaptive_learning_rate=True), 8, 4),
    "k4_adaptive": ("termination", JSolver(**TERMINATION, adaptive_learning_rate=True,
                                           termination_check_interval=4), 8, 4),
    "8_ranks": ("pair", JSolver(max_iterations=30, learning_rate=1.0,
                                sobolev_smoothing=True), 6, 8),
}


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """``{case: (JAX result as numpy, the port's ranks' results)}``, and
    under ``"fusion8"`` JAX's sharded fusion on 8 devices and the port's on
    8 ranks (run in the same spawn as the 8-rank solve)."""
    pair = make_pair_fields()[:2]
    fields = {"pair": pair, "3d": _fields_3d(), "termination": _termination_fields()}
    fields = {k: tuple(np.asarray(a) for a in v) for k, v in fields.items()}
    jax_res, by_world = {}, {}
    for name, (key, params, halo, world) in CASES.items():
        c, l = fields[key]
        res = solve_single_level_sharded(jnp.asarray(c), jnp.asarray(l), params,
                                         mesh=make_mesh(world), live_halo=halo)
        jax_res[name] = jax.tree.map(np.asarray, res)
        port = solver_params_from_jax(dataclasses.asdict(params))
        by_world.setdefault(world, []).append((name, (c, l, port, halo)))
    jfusion8, pfusion = _fusion_inputs(8)
    got = {}
    for world, cases in by_world.items():
        ranks = run_ranks("tests.torch_ranks.solve_cases", world,
                          tmp_path_factory.mktemp(f"solve{world}"),
                          {"solves": [c for _, c in cases],
                           "fusion": pfusion if world == 8 else None})
        for i, (name, _) in enumerate(cases):
            got[name] = [r["solves"][i] for r in ranks]
        if world == 8:
            got["fusion8"] = (jfusion8, [r["fusion"] for r in ranks])
    return {**{name: (jax_res[name], got[name]) for name in CASES},
            "fusion8": got["fusion8"]}


def _check(jres, ranks):
    """tests/test_parallel.py::_parity's checks, the port's ranks against
    JAX's sharded result."""
    warp = np.concatenate([r[0] for r in ranks])
    its = {r[1] for r in ranks}
    assert its == {int(jres.iterations)}, (its, int(jres.iterations))
    assert {r[2] for r in ranks} == {bool(jres.converged)}
    np.testing.assert_allclose(warp, jres.warp, atol=2e-5, rtol=1e-4)
    n = int(jres.iterations)
    for r in ranks:
        for name, got in zip(TEL, r[3]):
            assert got.shape == getattr(jres.telemetry, name).shape
            np.testing.assert_allclose(got[:n], getattr(jres.telemetry, name)[:n],
                                       atol=1e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(r[4], jres.max_abs_displacement, rtol=3e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["tikhonov", "tikhonov_sobolev", "killing_levelset",
                                  "8_ranks", "3d"])
def test_parity_with_jax(case, solves):
    _check(*solves[case])


@pytest.mark.parametrize("adaptive", [False, True])
def test_termination_check_interval_semantics(adaptive, solves):
    """k > 1: one reduction round and one host read every k iterations. The
    port follows JAX's trajectory at k = 1 and at k = 4; and, as JAX's test
    asserts of JAX, the k = 4 run stops at a multiple of 4 within 3
    iterations of the k = 1 run, with the same telemetry up to there (when
    the rate is adaptive it halves at most once a round at k = 4, so the
    trajectories part once a round's energy rises)."""
    suffix = "_adaptive" if adaptive else ""
    (j1, r1), (j4, r4) = solves["k1" + suffix], solves["k4" + suffix]
    _check(j1, r1)
    _check(j4, r4)
    n1, n4 = r1[0][1], r4[0][1]
    assert n4 % 4 == 0 and n1 <= n4 < n1 + 4
    assert r4[0][2]
    if not adaptive:
        for a, b in zip(r1[0][3], r4[0][3]):
            np.testing.assert_allclose(a[:n1], b[:n1], rtol=1e-6, atol=1e-8)


# --- the fusion, checkpoints and the CLI -----------------------------------------

SEQ = dict(width=32, height=32, blob_radius_px=6.0, blob_height=0.05,
           drift_px_per_frame=(1.0, 0.0), pulse_amplitude=0.05)
GRID = dict(shape=(16, 16, 16), voxel_size=0.01, offset=(-8, -8, 30))
FUSION_SOLVER = dict(max_iterations=12, learning_rate=0.3, smoothing_term_weight=0.1,
                     convergence_threshold=1e-3)


def _fusion_inputs(world):
    """tests/test_fusion_sharded.py::_setup's sequence and config: JAX's
    sharded fusion on ``world`` devices, and the port's arguments
    (frames, camera, config, live_halo)."""
    seq = jsynthetic.snoopy_style_sequence_3d(3, **SEQ)
    jcfg = jfusion.FusionPipelineConfig(grid=JGrid(**GRID), hierarchical=False,
                                        solver=JSolver(**FUSION_SOLVER))
    jres = jfusion.fuse_sequence_sharded(seq.frames, seq.camera, jcfg, mesh=make_mesh(world),
                                         live_halo=4)
    pseq = synthetic.snoopy_style_sequence_3d(3, **SEQ)
    assert all(np.array_equal(a, b) for a, b in zip(seq.frames, pseq.frames))
    pcfg = FusionPipelineConfig(grid=GridSpec(**GRID), hierarchical=False,
                                solver=solver_params_from_jax(dataclasses.asdict(jcfg.solver)))
    return jres, (list(pseq.frames), pseq.camera, pcfg, 4)


def _cli_config(presets, **kw):
    """tests/test_fusion_sharded.py::test_cli_multi_frame_sharded_mode's."""
    cfg = dataclasses.replace(
        presets["config4_3d_fusion"], name="sharded_fusion_smoke",
        mode="multi_frame_sharded_3d", grid_shape=GRID["shape"], voxel_size=GRID["voxel_size"],
        grid_offset=GRID["offset"], num_frames=3, num_devices=4, live_halo=4,
        checkpoint_every=1, dataset_kwargs={"width": 32, "height": 32, "blob_radius_px": 6.0},
        **kw)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(
        max_iterations=8, learning_rate=0.3, smoothing_term_weight=0.1,
        convergence_threshold=1e-3))


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    """JAX's sharded fusion, CLI run and sharded checkpoint, then the port's
    four ranks on the same inputs."""
    tmp = tmp_path_factory.mktemp("fusion")
    jres, pfusion = _fusion_inputs(4)
    jcli = jrun(_cli_config(JPRESETS), str(tmp / "jax_cli"))
    rng = np.random.default_rng(11)
    jstate = [rng.standard_normal(s).astype(np.float32) for s in ((8, 4, 6), (8, 4, 6),
                                                                 (8, 4, 6, 3))]
    sharding = NamedSharding(make_mesh(4), P("x"))
    jcheckpoint.save(str(tmp / "jax_ckpt"), 3,
                     jfusion.FusionState(*(jax.device_put(a, sharding) for a in jstate[:2])),
                     jax.device_put(jstate[2], sharding), {"config": "jax"})
    args = {"fusion": pfusion,
            "ckpt_root": str(tmp / "port_ckpt"), "cli_config": _cli_config(PRESETS),
            "cli_out": str(tmp / "port_cli"), "jax_ckpt": str(tmp / "jax_ckpt")}
    ranks = run_ranks("tests.torch_ranks.fusion_cases", 4, tmp, args)
    return {"jax": jres, "jax_cli": jcli, "jax_state": jstate, "ranks": ranks, "tmp": tmp}


@pytest.mark.parametrize("world", [4, 8])
def test_sharded_fusion_matches_jax(world, request):
    """tests/test_fusion_sharded.py's case on 4 ranks, and on 8, whose
    blocks of 2 rows are thinner than the blend's halo of 4: the blend then
    takes the exact gather fallback on both sides."""
    if world == 4:
        fusion = request.getfixturevalue("fusion")
        jres, ranks = fusion["jax"], [(r["state"], r["reports"]) for r in fusion["ranks"]]
    else:
        jres, ranks = request.getfixturevalue("solves")["fusion8"]
    (canonical, weights, warp), reports = ranks[0]
    np.testing.assert_allclose(canonical, np.asarray(jres.state.canonical), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(weights, np.asarray(jres.state.weights), atol=1e-5)
    np.testing.assert_allclose(warp, np.asarray(jres.final_warp), atol=2e-5, rtol=1e-4)
    for got, want in zip(reports, jres.reports):
        assert got["solver_iterations"] == want.solver_iterations
        assert got["band_voxels"] == want.band_voxels
        assert list(got["contract_violations"]) == list(want.contract_violations) == []
        np.testing.assert_allclose(got["max_abs_displacement"], want.max_abs_displacement,
                                   rtol=3e-4, atol=1e-7)
    assert all(r[1] == reports for r in ranks)


@pytest.mark.parametrize("live_halo", [0, 8])
def test_world_of_one_against_the_single_device_solve(live_halo):
    """A world of 1 in this process. With no live halo, B1 samples row i at
    float(i) + u as the single-device solve does, and B2's window is the
    whole volume: at k = 1 the sharded solve is ``solve_single_level``
    exactly. With a live halo of 8 B1 samples at float(8 + i) + u, and the
    warps part by that rounding only, within the JAX parity test's atol
    2e-5 / rtol 1e-4, after the same iterations."""
    c, l = (torch.from_numpy(np.array(a)) for a in _fields_3d())
    params = solver_params_from_jax(dataclasses.asdict(CASES["3d"][1]))
    want = solve_single_level(c, l, params)
    group = init_group("cpu")
    try:
        got = tsharded.solve_single_level_sharded(c, l, params, group=group, live_halo=live_halo)
    finally:
        close_group(group)
    assert got.iterations == want.iterations == 25
    if live_halo == 0:
        assert torch.equal(got.warp, want.warp)
        for a, b in zip(got.telemetry, want.telemetry):
            assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(got.warp, want.warp, atol=2e-5, rtol=1e-4)
        assert not torch.equal(got.warp, want.warp)


@pytest.mark.parametrize("kw", [dict(hierarchical=True), dict(mesh_axes=("x", "y"))],
                         ids=["hierarchical", "2d_mesh"])
def test_sharded_fusion_modes_on_a_world_of_one(kw):
    """The hierarchical and the 2D-mesh sharded fusion on a world of 1 (a
    (1, 1) mesh) against JAX's on one device: per-frame iterations exactly,
    the canonical atol 5e-5 rtol 1e-4 (tests/test_fusion_sharded.py's);
    the hierarchical fusion on the 2D mesh raises as JAX's does.
    tests/test_torch_hierarchical_sharded.py runs both on JAX's meshes."""
    kw = dict(kw)
    hierarchical, two_d = kw.pop("hierarchical", False), "mesh_axes" in kw
    seq = jsynthetic.snoopy_style_sequence_3d(3, **SEQ)
    jcfg = jfusion.FusionPipelineConfig(grid=JGrid(**GRID), hierarchical=hierarchical,
                                        levels=2, solver=JSolver(**FUSION_SOLVER))
    jres = jfusion.fuse_sequence_sharded(
        seq.frames, seq.camera, jcfg, live_halo=4, **kw,
        mesh=make_mesh_2d((1, 1)) if two_d else make_mesh(1))
    cfg = FusionPipelineConfig(grid=GridSpec(**GRID), hierarchical=hierarchical, levels=2,
                               solver=solver_params_from_jax(jcfg.solver))
    group = init_group("cpu")
    try:
        mesh = tmake_mesh_2d(group, (1, 1)) if two_d else group
        got = fuse_sequence_sharded(list(seq.frames), seq.camera, cfg, group=mesh,
                                    live_halo=4, **kw)
        if two_d:
            with pytest.raises(ValueError, match="1D mesh"):
                fuse_sequence_sharded(iter(()), None, dataclasses.replace(
                    cfg, hierarchical=True), group=mesh, **kw)
    finally:
        close_group(group)
    assert [r.solver_iterations for r in got.reports] == [
        r.solver_iterations for r in jres.reports]
    np.testing.assert_allclose(got.state.canonical, np.asarray(jres.state.canonical),
                               atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.final_warp, np.asarray(jres.final_warp), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("md0", [5.5, 6.0, 6.25, 11.0])
def test_live_halo_contract_matches_jax(md0):
    """The live-halo half of JAX's ``check_displacement_contract`` on axis 0:
    the same messages for the same max |u| (y and z are not sharded, so
    their 9s never count)."""
    md = np.array([md0, 9.0, 9.0], np.float32)
    want = jdebug.check_displacement_contract(
        SimpleNamespace(max_abs_displacement=md), live_halo=8, name="frame 3")
    got = check_displacement_contract(
        SimpleNamespace(max_abs_displacement=torch.from_numpy(md)), live_halo=8,
        name="frame 3")
    assert got == want and len(got) == (md0 > 6.0)


def test_cli_multi_frame_sharded_mode(fusion):
    summary, jsum = fusion["ranks"][0]["cli"], fusion["jax_cli"]
    assert summary["frames"] == jsum["frames"] == 3
    assert summary["devices"] == jsum["devices"] == 4
    out = str(fusion["tmp"] / "port_cli")
    assert os.path.isdir(os.path.join(out, "checkpoints"))
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["frames_per_s"] > 0
    assert set(jsum) - {"fast_paths", "final_pallas_max_displacement"} <= set(summary)
    assert [r["solver_iterations"] for r in summary["reports"]] == [
        r["solver_iterations"] for r in jsum["reports"]]
    state, warp, meta = checkpoint.load(os.path.join(out, "checkpoints"))
    assert meta["frame"] == 2 and meta["arrays"]["warp"]["sharded"]
    assert warp.shape == (16, 16, 16, 3) and state.canonical.shape == (16, 16, 16)


def test_sharded_checkpoint_roundtrip(fusion):
    """Each rank wrote its block; loading gives the whole arrays, or each
    rank its block, in JAX's meta layout."""
    ranks = fusion["ranks"]
    full = [np.concatenate([r["ckpt_blocks"][i] for r in ranks]) for i in range(3)]
    for r in ranks:
        for a, b in zip(r["ckpt_full"], full):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["ckpt_mine"], r["ckpt_blocks"]):
            np.testing.assert_array_equal(a, b)
    meta = ranks[0]["ckpt_meta"]
    assert meta["frame"] == 5 and meta["config"] == "c5"
    info = meta["arrays"]["warp"]
    assert info["sharded"] and info["shape"] == [16, 16, 16, 3] and info["dtype"] == "float32"
    assert [s["index"][0] for s in info["shards"]] == [[0, 4], [4, 8], [8, 12], [12, 16]]
    assert sorted(os.listdir(fusion["tmp"] / "port_ckpt" / "frame_000005")) == [
        "meta.json", "state.p0.npz", "state.p1.npz", "state.p2.npz", "state.p3.npz"]


def test_jax_sharded_checkpoint_loads_in_the_port(fusion):
    """A checkpoint JAX wrote from arrays sharded over 4 devices: whole in
    this process, and as each rank's block in the ranks."""
    state, warp, meta = checkpoint.load(str(fusion["tmp"] / "jax_ckpt"))
    assert meta["config"] == "jax" and meta["arrays"]["canonical"]["sharded"]
    want = fusion["jax_state"]
    for a, b in zip((*state, warp), want):
        np.testing.assert_array_equal(a.numpy(), b)
    for rank, r in enumerate(fusion["ranks"]):
        for a, b in zip(r["jax_blocks"], want):
            np.testing.assert_array_equal(a, b[2 * rank:2 * rank + 2])


SHARDED_SMALL = dict(grid_shape=(32, 24, 16), grid_offset=(-16, -12, 38), num_devices=4)


def _sharded_small(presets):
    cfg = dataclasses.replace(presets["config5_sharded"], **SHARDED_SMALL)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=20))


def _rows(path):
    with open(os.path.join(path, "telemetry.csv")) as f:
        return list(csv.DictReader(f))


def test_cli_sharded_3d_matches_jax(tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsum = jrun(_sharded_small(JPRESETS), jout)
    tsum = tcli.run_experiment(_sharded_small(PRESETS), tout, device="cpu")
    assert set(jsum) - {"fast_paths"} <= set(tsum)
    assert tsum["devices"] == 1 and jsum["devices"] == 4
    assert tsum["iterations"] == jsum["iterations"] == 20
    assert tsum["converged"] == jsum["converged"]
    assert tsum["contract_violations"] == jsum["contract_violations"] == []
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
    jrows, trows = _rows(jout), _rows(tout)
    assert len(trows) == len(jrows) == 20
    for a, b in zip(trows, jrows):
        for key in list(a)[3:]:
            np.testing.assert_allclose(float(a[key]), float(b[key]), rtol=2e-4, atol=1e-8)
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}  # CPU run
