"""The port's debug, profiling, visualization and telemetry utilities and
the CLI's --verbose, --profile and --check-nans, against JAX's
(utils/debug.py, utils/profiling.py, utils/visualization.py, the CLI's
artifacts and focus event).

Exact where the port computes the same thing (the iteration a diverging
solve goes non-finite, file names, event keys); the focus voxel's values
within the solve's rtol 3e-4 atol 3e-6 where it lands on JAX's voxel."""

import dataclasses
import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.cli import run_experiment as jrun
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.models.single_level import solve_single_level as jsolve
from levelsetfusion_tpu.utils import debug as jdebug
from levelsetfusion_tpu.utils import profiling as jprofiling
from levelsetfusion_tpu.utils.config import PRESETS as JPRESETS
from levelsetfusion_tpu_torch import cli as tcli
from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.utils import debug, profiling, visualization
from levelsetfusion_tpu_torch.utils.config import PRESETS


def _pair(shape, seed=0):
    base = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.tanh(base * 0.3), np.tanh(np.roll(base, 1, 0) * 0.3)


DIVERGING = dict(max_iterations=40, learning_rate=1e6, convergence_threshold=0.0)


@pytest.mark.parametrize("shape", [(8, 8), (8, 6, 5)])
def test_validate_solve_names_jax_iteration(shape):
    """A diverging rate: the port's validate_solve raises JAX's message,
    naming the same field and first non-finite iteration."""
    c, l = _pair(shape)
    want = jsolve(jnp.asarray(c), jnp.asarray(l), JSolver(**DIVERGING))
    with pytest.raises(jdebug.NonFiniteError) as jerr:
        jdebug.validate_solve(want)
    got = solve_single_level(torch.from_numpy(c), torch.from_numpy(l),
                             SolverParams(**DIVERGING))
    with pytest.raises(debug.NonFiniteError) as terr:
        debug.validate_solve(got)
    assert str(terr.value) == str(jerr.value)
    healthy = solve_single_level(torch.from_numpy(c), torch.from_numpy(l),
                                 SolverParams(max_iterations=5, learning_rate=0.3))
    debug.validate_solve(healthy)


def test_nan_checks_serial_loop_and_mode():
    """Under nan_checks a solve gives the graph loop's iterations and warp
    exactly, a diverging one raises at its first non-finite iteration, and
    the previous mode comes back on exit (also after the raise)."""
    c, l = (torch.from_numpy(a) for a in _pair((10, 8, 6)))
    params = SolverParams(max_iterations=30, learning_rate=0.3, convergence_threshold=1e-4)
    plain = solve_single_level(c, l, params)
    assert not debug.nan_checks_enabled()
    with debug.nan_checks():
        assert debug.nan_checks_enabled()
        checked = solve_single_level(c, l, params)
        with debug.nan_checks():
            pass
        assert debug.nan_checks_enabled()
    assert not debug.nan_checks_enabled()
    assert checked.iterations == plain.iterations
    assert torch.equal(checked.warp, plain.warp)
    for a, b in zip(checked.telemetry, plain.telemetry):
        assert torch.equal(a, b)
    diverging = solve_single_level(c, l, SolverParams(**DIVERGING))
    first_bad = min(int(np.argmax(~np.isfinite(t.numpy()))) for t in diverging.telemetry
                    if not np.isfinite(t.numpy()).all())
    with pytest.raises(debug.NonFiniteError, match=f"iteration {first_bad}:"):
        with debug.nan_checks():
            solve_single_level(c, l, SolverParams(**DIVERGING))
    assert not debug.nan_checks_enabled()


def test_tap_finite_passes_through_and_logs(caplog):
    x = torch.tensor([1.0, -3.0, 2.0])
    assert debug.tap_finite(x, "probe") is x
    with caplog.at_level(logging.ERROR, logger="levelsetfusion_tpu_torch.debug"):
        y = torch.tensor([1.0, float("nan"), -5.0])
        assert debug.tap_finite(y, "probe") is y
    assert "non-finite values in probe" in caplog.text and "5.0" in caplog.text


def test_contract_error_argument():
    res = type("R", (), {"max_abs_displacement": torch.tensor([7.5, 0.0, 0.0])})()
    assert len(debug.check_displacement_contract(res, live_halo=8)) == 1
    with pytest.raises(debug.DisplacementContractError, match="live_halo−2 = 6"):
        debug.check_displacement_contract(res, live_halo=8, error=True)
    assert debug.check_displacement_contract(res, live_halo=10, error=True) == []


def test_solver_roofline_at_128():
    """JAX's keys; the card's bytes: B1's 12.5 µs and B2's 20.0 µs at
    3.35 TB/s."""
    got = profiling.solver_roofline((128, 128, 128), 160e-6)
    assert set(got) == set(jprofiling.solver_roofline((128, 128, 128), 160e-6))
    voxels = 128 ** 3
    assert round(5 * 4 * voxels / 3.35e12 * 1e6, 1) == 12.5
    assert round(8 * 4 * voxels / 3.35e12 * 1e6, 1) == 20.0
    assert got["memory_bound_seconds"] == pytest.approx(52 * voxels / 3.35e12, rel=1e-12)
    assert round(got["memory_bound_seconds"] * 1e6, 1) == 32.6
    assert got["voxel_updates_per_s"] == pytest.approx(voxels / 160e-6)
    assert got["fraction_of_memory_roofline"] == pytest.approx(
        got["memory_bound_seconds"] / 160e-6)


def test_write_run_artifacts_names(tmp_path):
    rows = [{"iteration": i, "data_energy": 1.0 / (i + 1), "smoothing_energy": 0.5,
             "level_set_energy": 0.1, "total_energy": 1.6, "max_warp_update": 0.1,
             "mean_warp_update": 0.01} for i in range(4)]
    field = torch.zeros(12, 6, 10)
    warp = torch.zeros(12, 6, 10, 3)
    names = visualization.write_run_artifacts(str(tmp_path), rows, field, field, field, warp)
    assert names == ["energy.png", "canonical.png", "live.png", "warped_live.png", "warp.png"]
    assert sorted(os.listdir(tmp_path)) == sorted(names)
    video = visualization.FieldEvolutionVideo(str(tmp_path / "v.mp4"))
    for k in range(3):
        video.add_frame(torch.full((12, 6, 10), 0.3 * k - 0.3))
    video.close()
    assert (tmp_path / "v.mp4").stat().st_size > 0


def _small_config1(presets):
    cfg = presets["config1_2d_pair"]
    return dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=25))


def _events(out):
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def verbose_runs(tmp_path_factory):
    jout = str(tmp_path_factory.mktemp("jax_v"))
    tout = str(tmp_path_factory.mktemp("torch_v"))
    jrun(_small_config1(JPRESETS), jout, verbose=True)
    tcli.run_experiment(_small_config1(PRESETS), tout, device="cpu", verbose=True)
    return jout, tout


def test_cli_artifacts_and_focus_match_jax(verbose_runs):
    """config1 small with --verbose (tests/test_cli.py's run): the same plot
    files as JAX's CLI and the focus_voxel event with JAX's keys."""
    jout, tout = verbose_runs
    pngs = sorted(f for f in os.listdir(jout) if f.endswith(".png"))
    assert pngs == ["canonical.png", "energy.png", "live.png", "warp.png", "warped_live.png"]
    assert sorted(f for f in os.listdir(tout) if f.endswith(".png")) == pngs
    (jfocus,) = [e for e in _events(jout) if e["event"] == "focus_voxel"]
    (tfocus,) = [e for e in _events(tout) if e["event"] == "focus_voxel"]
    assert set(tfocus) == set(jfocus) == {"event", "name", "coords", "canonical", "live",
                                          "warped_live", "warp_u0", "warp_u1"}
    assert tfocus["name"] == jfocus["name"] and len(tfocus["coords"]) == 2
    if tfocus["coords"] == jfocus["coords"]:
        for key in ("canonical", "live", "warped_live", "warp_u0", "warp_u1"):
            np.testing.assert_allclose(tfocus[key], jfocus[key], rtol=3e-4, atol=3e-6)
    assert [e["event"] for e in _events(tout)] == [e["event"] for e in _events(jout)]


def test_cli_profile_and_check_nans(tmp_path, capsys):
    """--profile writes a torch.profiler trace under <out>/trace/;
    --check-nans runs the same iterations as a run without it."""
    cfg = tmp_path / "c1.json"
    cfg.write_text(_small_config1(PRESETS).to_json())
    plain, checked = str(tmp_path / "plain"), str(tmp_path / "checked")
    assert tcli.main(["--config", str(cfg), "--out", plain, "--device", "cpu"]) == 0
    assert tcli.main(["--config", str(cfg), "--out", checked, "--device", "cpu", "--profile",
                      "--check-nans", "--verbose"]) == 0
    assert not debug.nan_checks_enabled()
    trace = os.path.join(checked, "trace", "trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    summaries = []
    for out in (plain, checked):
        with open(os.path.join(out, "summary.json")) as f:
            summaries.append(json.load(f))
    assert summaries[0]["iterations"] == summaries[1]["iterations"] > 0
    assert summaries[0]["residual_after"] == summaries[1]["residual_after"]
    assert any(e["event"] == "focus_voxel" for e in _events(checked))


def test_artifacts_skipped_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the run is the same and one artifacts_skipped
    event names the module and the files not written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "run")
    summary = tcli.run_experiment(_small_config1(PRESETS), out, device="cpu")
    assert summary["iterations"] > 0
    (event,) = [e for e in _events(out) if e["event"] == "artifacts_skipped"]
    assert event["missing"] == ["matplotlib"]
    assert event["files"] == ["energy.png", "canonical.png", "live.png", "warped_live.png",
                              "warp.png"]
    assert not [f for f in os.listdir(out) if f.endswith(".png")]
