"""Each cell's entry path and the plain reference at small shapes on the
CPU: the program (its plain versions there) agrees with the reference within
the cell's limits, and the reference follows its definitions."""

import numpy as np
import pytest
import torch

from portbench.lib import traffic as gen
from portbench.reference import solver as ref
from portbench.reference import tsdf as ref_tsdf
from tiny import cell, run

WORKLOADS = ("config3-pairs", "config4-disk", "config4-memory", "config5_512-4chip")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_cpu(workload):
    line = run(cell(workload))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def test_reference_tsdf_matches_the_definition():
    cam = gen.Camera(8.0, 8.0, 8.0, 8.0, 16, 16)
    depth = torch.full((16, 16), 0.4)
    depth[0, 0] = 0.0
    out = ref_tsdf.generate(depth, cam, (4, 4, 6), 0.01, (-2, -2, 37), 4)
    # Voxel (2, 2, k): world (0, 0, (37 + k) cm), pixel (8, 8), depth 0.4 m.
    z = (torch.arange(6, dtype=torch.float32) + 37) * 0.01
    assert torch.allclose(out[2, 2], torch.clamp((0.4 - z) / 0.02, -1, 1))


def test_reference_resample_is_trilinear_with_unit_fill():
    field = torch.arange(27, dtype=torch.float32).reshape(3, 3, 3)
    warp = torch.zeros(3, 3, 3, 3)
    assert torch.equal(ref.resample(field, warp), field)
    warp[0] += 0.5  # halfway to the next x row; the last row meets the +1 fill
    out = ref.resample(field, warp)
    assert torch.allclose(out[0], 0.5 * (field[0] + field[1]))
    assert torch.allclose(out[2], 0.5 * (field[2] + 1.0))


def test_sobolev_taps():
    taps = ref.sobolev_taps(7, 0.1)
    assert len(taps) == 7 and abs(sum(taps) - 1) < 1e-6 and taps[3] == max(taps)
    assert taps == tuple(reversed(taps))


def test_solve_stops_and_halves_by_its_rules():
    rng = np.random.default_rng(0)
    canonical = torch.tensor(np.tanh(rng.standard_normal((8, 9, 10)) * 0.4), dtype=torch.float32)
    live = torch.roll(canonical, 1, 0)
    p = ref.Params(0.5, 7, 1e-3, 1.0, 0.1, 0.1, True, 0.1, ref.sobolev_taps(7, 0.1), True, 1)
    assert ref.solve(canonical, live, p).iterations == 7
    # Rounds of 4: the 7 iterations round up to 8.
    assert ref.solve(canonical, live, p._replace(k=4)).iterations == 8
    # Nothing to move (no level-set term on a field that is no distance): one iteration.
    assert ref.solve(canonical, canonical, p._replace(w_ls=0.0)).iterations == 1


def test_blend_is_the_running_weighted_average():
    c, w = torch.tensor([0.5, 1.0, -0.2]), torch.tensor([1.0, 0.0, 2.0])
    fused, total = ref.blend(c, w, torch.tensor([0.1, 1.0, 0.4]))
    assert torch.allclose(total, torch.tensor([2.0, 0.0, 3.0]))
    assert torch.allclose(fused, torch.tensor([0.3, 1.0, 0.0]))


def test_solve_takes_one_halving_decision_the_other_way():
    rng = np.random.default_rng(0)
    canonical = torch.tensor(np.tanh(rng.standard_normal((8, 9, 10)) * 0.4), dtype=torch.float32)
    live = torch.roll(canonical, 1, 0)
    p = ref.Params(0.5, 7, 1e-3, 1.0, 0.1, 0.1, True, 0.1, ref.sobolev_taps(7, 0.1), True, 1)
    sol = ref.solve(canonical, live, p)
    assert len(sol.energies) == len(sol.margins) == sol.iterations == 7
    assert sol.margins[0] == float("inf")
    e = sol.energies
    assert sol.margins[3] == pytest.approx(abs(e[3] - e[2]) / abs(e[2]))
    flipped = ref.solve(canonical, live, p, flip=3)
    assert flipped.energies[:4] == e[:4]  # the same up to the flipped decision
    assert not torch.equal(flipped.warp, sol.warp)


def test_a_tie_taken_the_other_way_is_judged_sound(monkeypatch, tmp_path):
    """A program answer whose solve took one of the reference's ties the
    other way passes against that flipped reference, where the reference's
    own solve would fail it."""
    from portbench.drivers import common, pair_solve
    from portbench.lib import harness, tracing

    c = cell("config3-pairs", 40)
    r = harness.Run(c, 5, 1.0, torch.device("cpu"), tracing.Tracer(False), str(tmp_path))
    state = pair_solve.State(r)
    monkeypatch.setattr(pair_solve, "TIE", 1.0)  # every decision a tie
    pair = state.pool[0]
    canonical, live = (common.reference_tsdf(r, pair.canonical),
                       common.reference_tsdf(r, pair.live))
    p = ref.params(c.config["solver"], rounds=False)
    nominal = ref.solve(canonical, live, p)
    first = min((m, k) for k, m in enumerate(nominal.margins))[1]
    sol = ref.solve(canonical, live, p, flip=first)
    got = pair_solve.Answer(canonical, live, sol.warp, ref.resample(live, sol.warp),
                            sol.iterations)
    want = pair_solve.Answer(canonical, live, nominal.warp,
                             ref.resample(live, nominal.warp), nominal.iterations)
    assert not harness.judge(list(pair_solve.compare(got, want).items()), c.limits)[0]
    row, flip = pair_solve.judged(r, state, 0, got)
    assert flip == first and harness.judge(list(row.items()), c.limits)[0]
