"""``loop_reuse_pct.solves``: the share of the stretch's solves that reused
the program's kept solve loop, from its ``solve.loop_kept`` and
``solve.loop_built`` counters; None untraced, with neither counter or on a
program that counts neither. On the card: a second solve of one key, from
another stream, replays the kept graph, gives the first one's answer and
is counted as kept."""

import pytest

from portbench.lib import cells, program
from test_portbench_spans import _readings


def _read(readings):
    return cells.reader("loop_reuse_pct.solves").read(readings)


@pytest.mark.parametrize("counts,want", [
    ({"solve.loop_kept": 31}, 100.0),
    ({"solve.loop_kept": 1, "solve.loop_built": 1}, 50.0),
    ({"solve.loop_built": 2, "halo.bytes_sent": 5}, 0.0),
])
def test_loop_reuse_share(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert _read(_readings()) == pytest.approx(want)


@pytest.mark.parametrize("counts,trace", [
    ({"solve.loop_kept": 31}, False),
    ({}, True),
    ({"halo.bytes_sent": 5}, True),
])
def test_loop_reuse_reads_nothing(monkeypatch, counts, trace):
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert _read(_readings(trace=trace)) is None


def test_loop_reuse_reads_nothing_from_a_program_that_counts_none(monkeypatch):
    from levelsetfusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read(_readings()) is None


@pytest.mark.card
def test_second_solve_reuses_the_kept_loop(card, tmp_path):
    import torch

    from levelsetfusion_tpu_torch.models.params import SolverParams
    from levelsetfusion_tpu_torch.models.single_level import (
        release_kept_loops,
        solve_single_level,
    )
    from levelsetfusion_tpu_torch.ops.kernels import fused_gradient
    from levelsetfusion_tpu_torch.utils import profiling

    gen = torch.Generator().manual_seed(7)
    canonical, live = (torch.tanh(torch.randn(32, 32, 24, generator=gen)).cuda()
                       for _ in range(2))
    params = SolverParams(max_iterations=40, learning_rate=0.3, convergence_threshold=0.0)
    release_kept_loops()
    with profiling.trace(str(tmp_path)):
        first = solve_single_level(canonical, live, params)
        captured = fused_gradient.captured_count
        with torch.cuda.stream(torch.cuda.Stream()):  # the kept loop waits for the first
            again = solve_single_level(canonical, live, params)
            torch.cuda.current_stream().synchronize()
    assert fused_gradient.captured_count == captured
    assert program.counters() == {"solve.loop_built": 1, "solve.loop_kept": 1}
    assert program.spans()["lsf.solve.capture"]["calls"] == 1  # the first call's
    assert _read(_readings()) == pytest.approx(50.0)
    assert torch.equal(first.warp, again.warp) and first.iterations == again.iterations
    release_kept_loops()
