"""The port's experiment runner against the JAX package's: config3 shrunk
to (24, 24, 16) with 20 iterations through both ``run_experiment``s —
summary numbers and telemetry.csv rows — plus the config plumbing between
the two packages and the CLI's refusals.

Tolerances: iteration count and ``converged`` exactly; telemetry rows and
energies rtol 2e-4 atol 1e-8 and max |u| rtol 3e-4 (tests/test_fused_gradient.py's solver
tolerances); band residuals rtol 1e-4 (means of |Φ_w − Φ_c| over the band)."""

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
    np.testing.assert_allclose(tsum["max_abs_displacement"], jsum["max_abs_displacement"],
                               rtol=3e-4)
    assert tsum["kernel_launches"] == {"resample": 0, "fused_gradient": 0}  # CPU run
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


@pytest.mark.parametrize("name", sorted(set(PRESETS) - {"config3_3d_full_energy"}))
def test_other_modes_raise(name, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        tcli.run_experiment(PRESETS[name], str(tmp_path), device="cpu")


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
