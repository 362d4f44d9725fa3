"""Two-process twin of tests/test_distributed_smoke.py: two real OS
processes (gloo ranks spawned by ``tests/torch_ranks.py``, meeting on
``init_group``'s ``FileStore``) sum a value across the process boundary,
then run the 1D sharded solve of that test's (8, 8, 8) fields, whose every
halo exchange crosses it. The solve's telemetry matches the single-device
port's at the JAX test's tolerances (atol 1e-5, rtol 1e-4; max |u| atol
1e-6). Its blocks of 4 rows are thinner than the Sobolev stencil halo of 5,
so the halos reach past the other rank into the fill."""

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from tests.torch_ranks import run_ranks


def _inputs():
    rng = np.random.default_rng(3)
    shape = (8, 8, 8)
    canonical = rng.uniform(-1, 1, shape).astype(np.float32)
    live = rng.uniform(-1, 1, shape).astype(np.float32)
    params = SolverParams(max_iterations=5, convergence_threshold=0.0, learning_rate=0.2,
                          sobolev_smoothing=True)
    return canonical, live, params


def test_two_process_distributed_solve(tmp_path):
    canonical, live, params = _inputs()
    cases = [("psum", (4, 4)),
             ("solve", dict(solver="sharded", canonical=canonical, live=live, params=params,
                            kw=dict(live_halo=4)))]
    ranks = run_ranks("tests.torch_ranks.mesh_cases", 2, tmp_path, {"cases": cases})
    ref = solve_single_level(torch.from_numpy(canonical), torch.from_numpy(live), params)
    for total, (warp, its, _, tel, md) in ranks:
        assert total == 16.0 + 32.0
        assert its == ref.iterations == 5
        for name, got, want in zip(ref.telemetry._fields, tel, ref.telemetry):
            np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(md, ref.max_abs_displacement.numpy(), atol=1e-6)
        np.testing.assert_allclose(warp, ref.warp.numpy(), atol=1e-5, rtol=1e-4)
