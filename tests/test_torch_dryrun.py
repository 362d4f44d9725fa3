"""The port's multi-device dry run (levelsetfusion_tpu_torch/dryrun.py),
the twin of ``__graft_entry__.py::dryrun_multichip``: its checks (2 sharded
iterations, warp parity with the single-device solve below 1e-5, the Schur
solvers converged to tau = 2e-3 within max(30 tau, 0.05 scale) of the
single-device solve, 2 hierarchical levels) hold on a world of 1 in this
process and on 4 gloo ranks, where the 2D mesh (2, 2) and Schur-2D run too."""

import re

from levelsetfusion_tpu_torch import dryrun
from levelsetfusion_tpu_torch.parallel import close_group, init_group
from tests.torch_ranks import run_ranks


def _checked(line, n):
    assert line.startswith(f"dryrun_multichip ok: {n} devices, shape ({8 * n}, 16, 128), "
                           "2 sharded solver iterations"), line
    parity = [float(v) for v in re.findall(r"parity[^=]*max\|Δ\|=([0-9.e+-]+)", line)]
    gaps = [float(v) for v in re.findall(r"threshold-matched gap ([0-9.e+-]+)", line)]
    assert parity and all(v < 1e-5 for v in parity)
    assert gaps and all(v < 30 * dryrun.TAU for v in gaps)
    return parity, gaps


def test_world_of_one_in_process():
    group = init_group("cpu")
    try:
        line = dryrun.dryrun_multichip(group)
    finally:
        close_group(group)
    parity, gaps = _checked(line, 1)
    assert len(parity) == 1 and len(gaps) == 1
    assert "2D mesh skipped (n_devices=1)" in line
    assert "level halos [None, 8]" in line


def test_four_gloo_ranks(tmp_path):
    lines = run_ranks("tests.torch_ranks.dryrun_case", 4, tmp_path)
    assert lines[1:] == [None, None, None]
    parity, gaps = _checked(lines[0], 4)
    assert len(parity) == 2 and len(gaps) == 2  # the 1D and (2, 2) solvers, Schur and Schur-2D
    assert "2D mesh (2,2) parity" in lines[0] and "schur2d (2,2)" in lines[0]


def test_main_prints_the_line(capsys):
    assert dryrun.main(["--device", "cpu"]) == 0
    _checked(capsys.readouterr().out.strip(), 1)
