"""The port's experiment runner against the JAX package's: config3 shrunk
to (24, 24, 16) with 20 iterations through both ``run_experiment``s —
summary numbers and telemetry.csv rows — config4 (``multi_frame_3d``)
shrunk to JAX's own test size ((32, 32, 24), 4 frames, 25 iterations, a
checkpoint every frame) with its resume, config1 and config2 (both
pyramids) and the two rigid presets at full size, every sharded preset
shrunk on one device, plus the config plumbing between the two packages
and the CLI's refusals.

Tolerances: iteration count and ``converged`` exactly; telemetry rows and
energies rtol 2e-4 atol 1e-8 and max |u| rtol 3e-4 (tests/test_fused_gradient.py's solver
tolerances); band residuals rtol 1e-4 (means of |Φ_w − Φ_c| over the band);
rigid extrinsics atol 1e-4 (tests/test_torch_rigid.py)."""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch import cli as tcli
from levelsetfusion_tpu_torch.utils import checkpoint
from levelsetfusion_tpu_torch.utils.config import PRESETS, ExperimentConfig

SHRINK = dict(grid_shape=(24, 24, 16), grid_offset=(-12, -12, 80))


def _small(presets):
    cfg = presets["config3_3d_full_energy"]
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=20), **SHRINK)


def _rows(path):
    with open(os.path.join(path, "telemetry.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    jout = str(tmp_path_factory.mktemp("jax"))
    tout = str(tmp_path_factory.mktemp("torch"))
    jsum = jrun(_small(JPRESETS), jout)
    tsum = tcli.run_experiment(_small(PRESETS), tout, device="cpu")
    return jout, jsum, tout, tsum


def test_summary_matches_jax(both_runs):
    _, jsum, tout, tsum = both_runs
    for name in ("config.json", "telemetry.csv", "events.jsonl", "summary.json"):
        assert os.path.exists(os.path.join(tout, name)), name
    with open(os.path.join(tout, "summary.json")) as f:
        assert json.load(f) == tsum
    shared = set(jsum) - {"fast_paths", "contract_violations"}
    assert shared <= set(tsum)
    assert tsum["iterations"] == jsum["iterations"] == 20
    assert tsum["converged"] == jsum["converged"]
    np.testing.assert_allclose(tsum["final_data_energy"], jsum["final_data_energy"], rtol=2e-4)
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    assert tsum["residual_after"] < tsum["residual_before"]
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}  # CPU run
    assert tsum["device"] == "cpu"


def test_telemetry_rows_match_jax(both_runs):
    jout, _, tout, _ = both_runs
    jrows, trows = _rows(jout), _rows(tout)
    assert len(trows) == len(jrows) == 20
    assert list(trows[0]) == list(jrows[0])
    for a, b in zip(trows, jrows):
        assert (a["level"], a["frame"], a["iteration"]) == (b["level"], b["frame"], b["iteration"])
        for key in list(a)[3:]:
            np.testing.assert_allclose(float(a[key]), float(b[key]), rtol=2e-4, atol=1e-8)


def test_events_match_jax(both_runs):
    jout, _, tout, _ = both_runs
    with open(os.path.join(jout, "events.jsonl")) as f:
        jev = [json.loads(line) for line in f]
    with open(os.path.join(tout, "events.jsonl")) as f:
        tev = [json.loads(line) for line in f]
    assert tev == [e for e in jev if e["event"] == "solve_done"]


def test_jax_config_json_loads(both_runs):
    """A JAX run's config.json reads into the port's config (TPU-only solver
    fields dropped) and equals the port's own shrunk preset."""
    jout = both_runs[0]
    with open(os.path.join(jout, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    assert cfg == _small(PRESETS)
    assert ExperimentConfig.from_json(cfg.to_json()) == cfg


def test_presets_mirror_jax():
    assert set(PRESETS) == set(JPRESETS)
    for name, cfg in PRESETS.items():
        assert ExperimentConfig.from_json(JPRESETS[name].to_json()) == cfg, name


RUNS = ("config1_2d_pair", "config2_2d_hierarchical", "config3_3d_full_energy",
        "rigid_2d", "rigid_3d")


SHARDED = ("config5_2dmesh", "config5_512", "config5_hierarchical", "config5_schur2d",
           "config5_sharded", "config5_sharded_schur")
SHARDED_SMALL = dict(grid_shape=(32, 24, 16), num_devices=1)


@pytest.mark.parametrize("name", sorted(set(PRESETS) - set(RUNS) - set(SHARDED)))
def test_other_modes_raise(name, tmp_path):
    """config4's mode runs from depth PNGs (tests/test_torch_datasets.py);
    a ``depth_directory`` without a path has no calibration file, and the
    run raises naming what it looked for, as JAX's does."""
    cfg = dataclasses.replace(PRESETS[name], dataset="depth_directory", dataset_kwargs={})
    with pytest.raises(FileNotFoundError, match="no calibration file"):
        tcli.run_experiment(cfg, str(tmp_path), device="cpu")


def _sharded_small(presets, name):
    cfg = PRESETS[name]
    # The grid starts 0.304 m from the camera, in the band of the blob pair.
    kw = dict(SHARDED_SMALL, mesh_shape=(1, 1) if cfg.mesh_shape is not None else None,
              grid_offset=(-16, -12, round(0.304 / cfg.voxel_size)))
    cfg = dataclasses.replace(presets[name], **kw)
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=16))


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_presets_match_jax(name, tmp_path):
    """Every sharded preset, shrunk to (32, 24, 16) and 16 iterations,
    through both CLIs on one device: the port on a world of 1 (a
    ``mesh_shape`` (1, 1) where the preset has a mesh), JAX on a mesh of
    1. Iterations (outer steps, per-level iterations and halos) and
    ``converged`` exactly, residuals rtol 1e-4, max |u| rtol 3e-4, JAX's
    summary keys. tests/test_torch_parallel2d.py, test_torch_schur.py and
    test_torch_hierarchical_sharded.py run them on JAX's meshes."""
    jsum = jrun(_sharded_small(JPRESETS, name), str(tmp_path / "jax"))
    tsum = tcli.run_experiment(_sharded_small(PRESETS, name), str(tmp_path / "torch"),
                               device="cpu")
    assert set(jsum) - {"fast_paths"} <= set(tsum)
    assert tsum["devices"] == jsum["devices"] == 1
    for key in ("iterations", "converged", "contract_violations", "solver_kind",
                "outer_steps", "inner_per_outer", "iterations_per_level",
                "level_live_halos"):
        assert tsum.get(key) == jsum.get(key), key
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    assert tsum["residual_after"] < tsum["residual_before"]
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}  # CPU run


def test_main_list_and_cpu_config_run(tmp_path, capsys):
    assert tcli.main(["--list"]) == 0
    assert "config3_3d_full_energy" in capsys.readouterr().out
    path = tmp_path / "c3.json"
    cfg = _small(PRESETS)
    path.write_text(dataclasses.replace(
        cfg, solver=cfg.solver.replace(max_iterations=3)).to_json())
    out = tmp_path / "run"
    assert tcli.main(["--config", str(path), "--out", str(out), "--device", "cpu"]) == 0
    with open(out / "summary.json") as f:
        assert json.load(f)["iterations"] == 3


def test_cuda_device_requires_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--preset", "config3_3d_full_energy", "--out", str(tmp_path)])


C4_SHRINK = dict(grid_shape=(32, 32, 24), voxel_size=0.008, grid_offset=(-16, -16, 42),
                 num_frames=4, checkpoint_every=1)


def _small_c4(presets, **kw):
    """tests/test_cli.py's small config4."""
    cfg = presets["config4_3d_fusion"]
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=25),
                               **{**C4_SHRINK, **kw})


@pytest.fixture(scope="module")
def c4_runs(tmp_path_factory):
    jout = str(tmp_path_factory.mktemp("jax_c4"))
    tout = str(tmp_path_factory.mktemp("torch_c4"))
    jsum = jrun(_small_c4(JPRESETS), jout)
    tsum = tcli.run_experiment(_small_c4(PRESETS), tout, device="cpu")
    return jout, jsum, tout, tsum


def test_multi_frame_summary_matches_jax(c4_runs):
    """JAX's summary keys, less the TPU fast paths and the clamp contract,
    plus the device and the launches; the same frames and per-frame
    iteration counts; band voxels, energies and max |u| within tolerance."""
    jout, jsum, tout, tsum = c4_runs
    with open(os.path.join(tout, "summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(tsum))  # tuples as lists
    left_out = {"fast_paths", "contract_violations", "final_pallas_max_displacement"}
    assert set(tsum) == (set(jsum) - left_out) | {"device", "kernel_launches"}
    for key in ("frames", "dataset", "frames_processed"):
        assert tsum[key] == jsum[key], key
    assert tsum["frames_per_s"] > 0 and tsum["frames_per_s_incl_compile"] > 0
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}  # CPU run
    assert tsum["device"] == "cpu"
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4, atol=3e-6)
    assert [r["frame_index"] for r in tsum["reports"]] == [1, 2, 3]
    for a, b in zip(tsum["reports"], jsum["reports"]):
        assert set(a) == set(b)
        assert a["solver_iterations"] == b["solver_iterations"]
        np.testing.assert_allclose(a["band_voxels"], b["band_voxels"], rtol=1e-3)
        np.testing.assert_allclose(a["final_data_energy"], b["final_data_energy"], rtol=2e-4)
    with open(os.path.join(tout, "events.jsonl")) as f:
        tev = [json.loads(line) for line in f]
    with open(os.path.join(jout, "events.jsonl")) as f:
        jev = [json.loads(line) for line in f]
    assert [(e["event"], e["frame"]) for e in tev] == [(e["event"], e["frame"]) for e in jev]
    assert sorted(os.listdir(os.path.join(tout, "checkpoints"))) == sorted(
        os.listdir(os.path.join(jout, "checkpoints")))


class _Stop(Exception):
    pass


def test_multi_frame_resume_equals_uninterrupted(c4_runs, tmp_path, monkeypatch):
    """A run stopped after frame 2's checkpoint and resumed with --resume
    ends with the uninterrupted run's state and warp, exactly, and reports
    the frames it fused; a second resume has nothing left to do."""
    _, _, tout, tsum = c4_runs
    out = str(tmp_path / "stopped")
    save = checkpoint.save

    def save_then_stop(root, frame, *args, **kw):
        path = save(root, frame, *args, **kw)
        if frame == 2:
            raise _Stop
        return path

    monkeypatch.setattr(checkpoint, "save", save_then_stop)
    with pytest.raises(_Stop):
        tcli.run_experiment(_small_c4(PRESETS), out, device="cpu")
    monkeypatch.setattr(checkpoint, "save", save)
    assert checkpoint.latest_frame(os.path.join(out, "checkpoints")) == 2
    config = os.path.join(out, "config.json")
    assert tcli.main(["--config", config, "--out", out, "--device", "cpu", "--resume"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        resumed = json.load(f)
    assert resumed["frames_processed"] == 2
    assert resumed["reports"] == json.loads(json.dumps(tsum["reports"][2:]))
    want_state, want_warp, _ = checkpoint.load(os.path.join(tout, "checkpoints"), 3)
    got_state, got_warp, meta = checkpoint.load(os.path.join(out, "checkpoints"), 3)
    assert meta["final"]
    for a, b in zip((*got_state, got_warp), (*want_state, want_warp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    noop = tcli.run_experiment(_small_c4(PRESETS), out, device="cpu", resume=True)
    assert noop["frames"] == 0 and noop["resumed_from"] == 3


TWO_D = {"config1": ("config1_2d_pair", {}),
         "config2_ewa_depth": ("config2_2d_hierarchical", {}),
         "config2_block_mean": ("config2_2d_hierarchical", {"pyramid_method": "block_mean"})}


@pytest.fixture(scope="module", params=sorted(TWO_D))
def two_d_runs(request, tmp_path_factory):
    name, kw = TWO_D[request.param]
    jout = str(tmp_path_factory.mktemp("jax_" + request.param))
    tout = str(tmp_path_factory.mktemp("torch_" + request.param))
    jsum = jrun(dataclasses.replace(JPRESETS[name], **kw), jout)
    tsum = tcli.run_experiment(dataclasses.replace(PRESETS[name], **kw), tout, device="cpu")
    return jout, jsum, tout, tsum


def test_2d_modes_match_jax(two_d_runs):
    """config1 (``single_pair_2d``) and config2 (``hierarchical_2d``, its EWA
    depth pyramid and the block-mean one) at full size: JAX's summary keys
    less its fast paths and contract, plus the device and the launches; the
    iterations (per level) and ``converged`` exactly; residuals, energies,
    max |u|, the telemetry rows and the events."""
    jout, jsum, tout, tsum = two_d_runs
    with open(os.path.join(tout, "summary.json")) as f:
        assert json.load(f) == tsum
    assert set(tsum) == (set(jsum) - {"fast_paths", "contract_violations"}) | {
        "device", "kernel_launches"}
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}  # CPU run
    for key in ("iterations", "converged", "levels", "iterations_per_level"):
        assert tsum.get(key) == jsum.get(key), key
    for key in ("residual_before", "residual_after", "residual_reduction"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-4)
    assert tsum["residual_reduction"] > 2.0
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4, atol=3e-6)
    if "final_data_energy" in jsum:
        np.testing.assert_allclose(tsum["final_data_energy"], jsum["final_data_energy"],
                                   rtol=2e-4)
    jrows, trows = _rows(jout), _rows(tout)
    assert len(trows) == len(jrows) > 0
    for a, b in zip(trows, jrows):
        assert (a["level"], a["frame"], a["iteration"]) == (b["level"], b["frame"], b["iteration"])
        for key in list(a)[3:]:
            # Each package solves from its own TSDFs (1 ulp apart, BASIC):
            # the max over voxels of ‖δu‖, ~1e-3 late in config2's finest
            # level, moves by up to 6.4e-7 with them, so it takes atol 1e-6.
            atol = 1e-6 if key == "max_warp_update" else 1e-8
            np.testing.assert_allclose(float(a[key]), float(b[key]), rtol=2e-4, atol=atol)
    with open(os.path.join(tout, "events.jsonl")) as f:
        tev = [json.loads(line) for line in f]
    with open(os.path.join(jout, "events.jsonl")) as f:
        jev = [json.loads(line) for line in f]
    assert tev == [e for e in jev if e["event"] == "solve_done"]


@pytest.mark.parametrize("name", ["rigid_2d", "rigid_3d"])
def test_rigid_modes_match_jax(name, tmp_path):
    """The rigid modes: JAX's summary keys (plus the device and the
    launches, 0 here and on the card: these modes run no kernel), its true
    extrinsic exactly, the estimate within 1e-4 and the pose error within
    the JAX tests' 2e-3."""
    jsum = jrun(JPRESETS[name], str(tmp_path / "jax"))
    tsum = tcli.run_experiment(PRESETS[name], str(tmp_path / "torch"), device="cpu")
    assert set(tsum) == set(jsum) | {"device", "kernel_launches"}
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0, "step2d": 0,
                                       "loop_tail": 0}
    np.testing.assert_array_equal(tsum["true_extrinsic"], jsum["true_extrinsic"])
    np.testing.assert_allclose(tsum["estimated_extrinsic"], jsum["estimated_extrinsic"],
                               rtol=0, atol=1e-4)
    assert tsum["pose_error"] <= 2e-3
    np.testing.assert_allclose(tsum["pose_error"], jsum["pose_error"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tsum["initial_energy"], jsum["initial_energy"], rtol=1e-3)
    assert tsum["final_energy"] < 0.2 * tsum["initial_energy"]


def test_main_runs_a_2d_preset(tmp_path):
    """The CLI's entry point runs a 2D preset on the CPU."""
    out = tmp_path / "rigid"
    assert tcli.main(["--preset", "rigid_2d", "--out", str(out), "--device", "cpu"]) == 0
    with open(out / "summary.json") as f:
        assert json.load(f)["pose_error"] <= 2e-3
