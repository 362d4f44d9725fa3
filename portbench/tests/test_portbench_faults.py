"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped and the rest of a run is driven on the
CPU at a small size, once for each fault a cell can have. (No cell averages
over a batch, so leaving half of one out is no fault any cell can have.)"""

import functools

import pytest

import levelsetfusion_tpu_torch.models.fusion as program_fusion
import levelsetfusion_tpu_torch.models.single_level as program_loop
from portbench.drivers import pair_solve
from portbench.lib import faults, harness
from tiny import cell, run

WORLD = 2


def test_pairs_state_unchanged(monkeypatch):
    monkeypatch.setattr(program_loop, "fused_gradient_update", faults.frozen_step)
    assert not run(cell("config3-pairs"))["correct"]


def test_pairs_answer_altered(monkeypatch):
    monkeypatch.setattr(pair_solve, "warp_field_cm",
                        faults.shifted(pair_solve.warp_field_cm, 0.1))
    assert not run(cell("config3-pairs"))["correct"]


@pytest.mark.parametrize("workload", ["config4-disk", "config4-memory"])
def test_fusion_state_unchanged(monkeypatch, workload):
    monkeypatch.setattr(program_fusion, "blend", lambda state, warped: state)
    assert not run(cell(workload))["correct"]


@pytest.mark.parametrize("workload", ["config4-disk", "config4-memory"])
def test_fusion_answer_altered(monkeypatch, workload):
    real = program_fusion.blend

    def altered(state, warped):
        fused = real(state, warped)
        return fused._replace(canonical=fused.canonical + 0.1)

    monkeypatch.setattr(program_fusion, "blend", altered)
    assert not run(cell(workload))["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_sharded_faults(fault):
    args = ["--workload", "config5_512-4chip", "--seed", "11", "--seconds", "0.5"]
    results = faults.run_ranks(functools.partial(cell, "config5_512-4chip"), args, WORLD,
                               fault, device="cpu", timeout_s=300)
    assert harness.result_line(cell("config5_512-4chip"), results, False)["correct"] == (
        fault == "none")
