"""The port's communication accounting (parallel/scaling.py): JAX's
hand-computed cases (tests/test_scaling.py) where the port's sends have
JAX's structure, and, exactly, the bytes, rounds (``batch_isend_irecv``
calls) and reductions (``all_reduce`` calls) that a counting shim around
``torch.distributed`` records on the busiest of 4 gloo ranks, for the 1D
sync solver (with a halo deeper than the blocks: multi-hop), the Schur
solver, and the sync and Schur-2D solvers on a (2, 2) mesh."""

import numpy as np
import pytest

from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.parallel.scaling import comm_bytes_per_iteration as jcomm
from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.parallel import scaling
from tests.torch_ranks import run_ranks

PLANE = 512 * 512 * 4


def test_sync_bytes_hand_computed():
    """tests/test_scaling.py's (512³)/8 case with Sobolev (hx = 5): JAX's
    per-iteration bytes, overlappable bytes and rounds; once a solve the
    port also exchanges the canonical's 5 rows beside the live field's 8."""
    p = SolverParams(sobolev_smoothing=True)
    b = scaling.comm_bytes_per_iteration((512, 512, 512), (8,), p)
    want = jcomm((512, 512, 512), (8,), JSolver(sobolev_smoothing=True), fused=True)
    assert b.bytes_per_iteration == want.bytes_per_iteration == 5 * 2 * 4 * PLANE
    assert b.bytes_overlappable_per_iteration == want.bytes_overlappable_per_iteration
    assert b.ppermute_rounds_per_iteration == want.ppermute_rounds_per_iteration == 2.0
    assert b.reduction_rounds_per_iteration == want.reduction_rounds_per_iteration == 1.0
    assert want.bytes_once_per_solve == 8 * 2 * PLANE
    assert b.bytes_once_per_solve == (8 + 5) * 2 * PLANE
    assert (b.rounds_once_per_solve, b.reductions_once_per_solve) == (2, 3)


def test_termination_interval_amortizes_reductions():
    p = SolverParams(sobolev_smoothing=True, termination_check_interval=4)
    b = scaling.comm_bytes_per_iteration((512, 512, 512), (8,), p)
    assert b.reduction_rounds_per_iteration == pytest.approx(0.25)
    # The adaptive rate's psum is its own all_reduce in the port.
    b = scaling.comm_bytes_per_iteration((512, 512, 512), (8,),
                                         p.replace(adaptive_learning_rate=True))
    assert b.reduction_rounds_per_iteration == pytest.approx(0.5)


def test_schur_amortizes_bytes():
    p = SolverParams(sobolev_smoothing=True)
    sync = scaling.comm_bytes_per_iteration((512, 512, 512), (8,), p)
    schur = scaling.comm_bytes_per_iteration((512, 512, 512), (8,), p, solver_kind="schur",
                                             inner_iterations=8)
    assert schur.bytes_per_iteration * 8 == 3 * 2 * 3 * PLANE
    assert schur.bytes_per_iteration < sync.bytes_per_iteration / 10
    assert schur.ppermute_rounds_per_iteration == pytest.approx(2 / 8)
    assert schur.reduction_rounds_per_iteration == pytest.approx(2 / 8)


def test_2d_mesh_counts_the_port_structure():
    """1D: JAX's number. On (2, 4): each rank has one neighbour along axis 0
    (two ranks) and the column exchanges carry the row-extended block
    (n0 + 2 hx rows), where JAX counts two sides and x_local rows."""
    p = SolverParams(sobolev_smoothing=False)
    b1 = scaling.comm_bytes_per_iteration((128, 64, 128), (8,), p)
    assert b1.bytes_per_iteration == 2 * 2 * 4 * 64 * 128 * 4
    b2 = scaling.comm_bytes_per_iteration((128, 64, 128), (2, 4), p)
    rows = 2 * 1 * 4 * 16 * 128 * 4  # hx 2, one side, 3 + 1 channels, (16, 128) planes
    cols = 2 * 2 * 4 * (64 + 4) * 128 * 4  # two sides, (68, 128) planes
    assert b2.bytes_per_iteration == rows + cols
    assert b2.ppermute_rounds_per_iteration == 4.0
    want = jcomm((128, 64, 128), (2, 4), JSolver(sobolev_smoothing=False), fused=True)
    assert want.bytes_per_iteration == 2 * 2 * 4 * (16 * 128 + 64 * 128) * 4


def test_multi_hop_slices():
    # A 5-slice halo over 3-slice blocks: 3 from the neighbour, 2 from the
    # next; the busiest of 4 ranks reaches both on one side, one on the other.
    assert scaling.sent_slices(5, 3, 4) == 5 + 3
    assert scaling.sent_slices(5, 3, 8) == 10
    assert scaling.sent_slices(2, 8, 2) == 2
    assert scaling.sent_slices(2, 8, 1) == 0


def test_predictions():
    p = SolverParams(sobolev_smoothing=True)
    pred = scaling.predict_efficiency((512, 512, 512), (8,), p)
    assert pred.compute_s_per_iteration == scaling.CONFIG5_512_S_PER_ITER
    assert pred.comm_s_per_iteration == pytest.approx(5 * 2 * 4 * PLANE / 4.5e11)
    assert 0.9 < pred.efficiency < 1.0
    assert scaling.predict_efficiency((512, 512, 512), (8,), p, overlap=1.0).efficiency \
        > pred.efficiency
    sync2d = scaling.predict_efficiency_2d((512, 512, 512), (2, 4), p)
    schur2d = scaling.predict_efficiency_2d((512, 512, 512), (2, 4), p, solver_kind="schur2d")
    assert schur2d.assumptions["slow_axis_rounds_per_iteration"] < \
        sync2d.assumptions["slow_axis_rounds_per_iteration"]
    assert schur2d.efficiency > sync2d.efficiency
    with pytest.raises(ValueError):
        scaling.predict_efficiency((512, 512, 512), (8,), p, solver_kind="schur2d")


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    return np.tanh(base * 0.3), np.tanh(np.roll(base, 1, axis=0) * 0.3)


SOB = dict(sobolev_smoothing=True, smoothing_mode=SmoothingMode.KILLING, learning_rate=0.3,
           convergence_threshold=0.0)
CASES_1D = {
    "sync": ((32, 12, 16), dict(max_iterations=3, **SOB), {"live_halo": 8}),
    "sync_multi_hop": ((12, 12, 16), dict(max_iterations=2, **SOB), {"live_halo": 8}),
    "sync_adaptive_k2": ((32, 12, 16), dict(max_iterations=4, termination_check_interval=2,
                                            adaptive_learning_rate=True, **SOB),
                         {"live_halo": 6}),
    "schur": ((32, 12, 16), dict(max_iterations=8, **SOB),
              {"live_halo": 8, "inner_iterations": 4}),
}
CASES_2D = {
    "sync2d": ((16, 24, 16), dict(max_iterations=3, **SOB), {"live_halo": 8}),
    "schur2d": ((16, 24, 16), dict(max_iterations=8, **SOB),
                {"live_halo": 8, "inner_iterations": 4}),
}
SOLVER = {"sync": "sharded", "sync_multi_hop": "sharded", "sync_adaptive_k2": "sharded",
          "schur": "schur", "sync2d": "sharded2d", "schur2d": "schur2d"}
KIND = {"sharded": "sync", "sharded2d": "sync", "schur": "schur", "schur2d": "schur2d"}


def _payload(name, cases):
    shape, params, kw = cases[name]
    canonical, live = _fields(shape, len(name))
    return ("comm", {"solver": SOLVER[name], "canonical": canonical, "live": live,
                     "params": SolverParams(**params), "kw": kw})


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = {}
    for mesh, cases in ((None, CASES_1D), ((2, 2), CASES_2D)):
        names = sorted(cases)
        ranks = run_ranks("tests.torch_ranks.mesh_cases", 4,
                          tmp_path_factory.mktemp(f"comm_{mesh}"),
                          {"mesh": mesh, "cases": [_payload(n, cases) for n in names]})
        for i, name in enumerate(names):
            out[name] = [rank[i] for rank in ranks]
    return out


@pytest.mark.parametrize("name", sorted({**CASES_1D, **CASES_2D}))
def test_accounting_equals_the_sends(counted, name):
    """Bytes, rounds and reductions of the busiest rank (max over the 4)
    equal the accounting's totals for the iterations the solve ran."""
    shape, params, kw = {**CASES_1D, **CASES_2D}[name]
    mesh = (2, 2) if name in CASES_2D else (4,)
    kind = KIND[SOLVER[name]]
    inner = kw.get("inner_iterations", 8)
    b = scaling.comm_bytes_per_iteration(shape, mesh, SolverParams(**params),
                                         live_halo=kw["live_halo"], solver_kind=kind,
                                         inner_iterations=inner)
    counts = [c for c, _ in counted[name]]
    steps = counted[name][0][1]
    iterations = steps * inner if kind.startswith("schur") else steps
    assert iterations == params["max_iterations"]
    assert max(c["bytes"] for c in counts) == b.total_bytes(iterations)
    assert max(c["rounds"] for c in counts) == pytest.approx(
        b.ppermute_rounds_per_iteration * iterations + b.rounds_once_per_solve)
    reductions = b.reduction_rounds_per_iteration * iterations + b.reductions_once_per_solve
    assert all(c["reductions"] == pytest.approx(reductions) for c in counts)
