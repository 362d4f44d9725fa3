"""``step2d_fused_pct.solves2d``: the share of the stretch's solver iterations
that ran the fused 2D step kernel, from the program's
``solve.step2d_iterations`` and ``solve.graph_iterations`` counters; None
untraced, without both counters or on a program that counts neither. Also
the config1-pairs fault of a frozen 2D step planted where the program now
makes it (the fused step's wrapper), on the CPU and on the card, and on the
card a profiled 2D solve reading 100."""

import pytest
import torch

import levelsetfusion_tpu_torch.models.single_level as program_loop
from levelsetfusion_tpu_torch.ops.kernels import step2d
from portbench.lib import cells, harness, program
from test_portbench_config1 import WORKLOAD, _readings, small
from tiny import run

NAME = "step2d_fused_pct.solves2d"


def _read(readings):
    return cells.reader(NAME).read(readings)


@pytest.mark.parametrize("counts,want", [
    ({"solve.step2d_iterations": 16 * 60, "solve.graph_iterations": 16 * 60}, 100.0),
    ({"solve.step2d_iterations": 16, "solve.graph_iterations": 64,
      "solve.graph_kernels": 1024}, 25.0),
])
def test_fused_share(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert _read(_readings()) == pytest.approx(want)


@pytest.mark.parametrize("counts,trace", [
    ({"solve.step2d_iterations": 16, "solve.graph_iterations": 16}, False),
    ({"solve.graph_iterations": 960, "solve.graph_kernels": 96 * 960}, True),
    ({"solve.step2d_iterations": 16}, True),
    ({}, True),
])
def test_fused_share_reads_nothing(monkeypatch, counts, trace):
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert _read(_readings(trace=trace)) is None


def test_fused_share_reads_nothing_from_a_program_that_counts_none(monkeypatch):
    from levelsetfusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read(_readings()) is None


def test_reported_in_config1_pairs_only():
    names = {w["name"]: [m["name"] for m in cells.cell(w["name"]).per_layer]
             for w in cells.benchmark()["workloads"]}
    assert [w for w, metrics in names.items() if NAME in metrics] == [WORKLOAD]


def _frozen_step(real):
    """The fused 2D step returning its state unchanged."""
    def frozen(live, canonical, warp_cm, rate, **kw):
        new, stats = real(live, canonical, warp_cm, rate, **kw)
        new.copy_(warp_cm)
        return new, stats
    return frozen


def test_frozen_step_is_not_correct(monkeypatch):
    program_loop.release_kept_loops()
    monkeypatch.setattr(step2d, "step2d", _frozen_step(step2d.step2d))
    assert not run(small())["correct"]
    program_loop.release_kept_loops()


@pytest.mark.card
def test_frozen_step_is_not_correct_on_the_card(card, monkeypatch):
    program_loop.release_kept_loops()  # a kept loop's graph holds the sound step
    monkeypatch.setattr(step2d, "step2d", _frozen_step(step2d.step2d))
    args = harness.parse(["--workload", WORKLOAD, "--seed", "4294967357", "--seconds", "3"])
    res = harness.run_rank(cells.cell(WORKLOAD), args, 0, 1, 0.0)
    line = harness.result_line(cells.cell(WORKLOAD), [res], False)
    program_loop.release_kept_loops()
    print(line["checks"])
    assert not line["correct"], line["checks"]


@pytest.mark.card
def test_a_profiled_2d_solve_reads_100(card, tmp_path):
    """config1's solve at its grid under a profiler: every replayed
    iteration is the fused kernel's."""
    from levelsetfusion_tpu_torch.models.params import SolverParams
    from levelsetfusion_tpu_torch.utils import profiling

    gen_ = torch.Generator().manual_seed(11)
    canonical, live = (torch.tanh(torch.randn(96, 48, generator=gen_)).cuda()
                       for _ in range(2))
    params = SolverParams(max_iterations=40, learning_rate=1.0, convergence_threshold=0.0)
    program_loop.release_kept_loops()
    with profiling.trace(str(tmp_path)):
        program_loop.solve_single_level(canonical, live, params)
    counts = program.counters()
    program_loop.release_kept_loops()
    assert counts["solve.step2d_iterations"] == counts["solve.graph_iterations"] == 48
    assert _read(_readings()) == pytest.approx(100.0)
