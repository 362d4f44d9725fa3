"""The port's 2D scanline path (config1's) against the benchmark's plain 2D
reference (``portbench/reference/tsdf2d.py``, ``solver2d.py``: plain torch
from the definitions, nothing of the port), on the CPU at a small size: a
(24, 16) grid at 4 mm in front of a 32 px scanline, seeded random
bump-on-a-wall pairs (``io/synthetic.py::bump_wall_pair_2d``), config1's
solver (data + Tikhonov 0.2, rate 1.0 fixed, gate 1e-3).

Tolerances, each with its reason:
- TSDF: the rule of the BASIC tests of ``test_torch_core.py``: |Δ| >
  1e-5 on at most 0.5% of voxels, since a rounding in the projection may
  move a voxel across a pixel boundary (none does here: the gap is 0);
- warp and warped field: rtol 3e-4, atol 3e-6, the solver tolerances of
  ``test_torch_single_level.py``: the two sides sum the same terms in
  other orders, and ~150 iterations carry the rounding (seen: 7.5e-8);
- each iteration's data and Tikhonov energy: rtol 2e-4, atol 1e-8, that
  file's telemetry tolerance (the reference sums in float64);
- iterations: exactly, since the stop compares a float32 norm with the
  float32 threshold on both sides.
The same comparison fails where the reference runs in bfloat16.
"""

import types

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models.params import SolverParams
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d
from portbench.reference import solver2d, tsdf2d
from tests.torch_parity import assert_close

GRID = GridSpec(shape=(24, 16), voxel_size=0.004, offset=(-12, 12))
BAND = 8  # voxels: the grid is 16 deep
SOLVER = dict(learning_rate=1.0, max_iterations=600, convergence_threshold=1e-3,
              data_term_weight=1.0, smoothing_term_weight=0.2, level_set_term_weight=0.0,
              smoothing_mode="tikhonov", sobolev_smoothing=False, adaptive_learning_rate=False,
              band_union_only=True)
PARAMS = SolverParams(learning_rate=1.0, max_iterations=600, convergence_threshold=1e-3)
SEEDS = range(5)


def _pair(seed):
    """A seeded bump-on-a-wall scanline pair at 8 cm, 32 px."""
    rng = np.random.default_rng(seed)
    return synthetic.bump_wall_pair_2d(
        width=32, wall_depth=0.08, bump_height=0.008, bump_radius_px=float(rng.uniform(4, 6)),
        bump_center_px=float(rng.uniform(15, 17)), live_shift_px=float(rng.uniform(-1.5, 1.5)),
        live_height_scale=float(rng.uniform(0.9, 1.1)))


def _tsdfs(depth, camera, dtype=torch.float32):
    """(the port's, the reference's) TSDF of one scanline."""
    row = torch.from_numpy(depth)
    cam = types.SimpleNamespace(fx=camera.fx, cx=camera.cx, width=camera.image_width)
    return (generate_tsdf_2d(row, camera, GRID, narrow_band_width_voxels=BAND),
            tsdf2d.generate(row, cam, GRID.shape, GRID.voxel_size, GRID.offset, BAND, dtype))


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_tsdf_matches_the_reference(seed, invalid):
    pair = _pair(seed)
    depth = pair.live_depth.copy()
    if invalid:
        depth[10:14] = 0.0  # invalid pixels: the voxels that see them get +1
    got, want = _tsdfs(depth, pair.camera)
    assert got.shape == want.shape == GRID.shape
    assert torch.any(torch.abs(want) < 1.0) and torch.any(want == 1.0)
    off = torch.abs(got - want) > 1e-5
    assert off.float().mean() <= 0.005, off.float().mean()


def _compare(got, warped, sol, live):
    """The program's solve against the reference's solution, by the
    module's tolerances."""
    warp, energies = sol.warp.float(), sol.energies.float()
    assert_close(to_component_major(got.warp), warp, rtol=3e-4, atol=3e-6)
    assert_close(warped, solver2d.resample(live.float(), warp), rtol=3e-4, atol=3e-6)
    assert got.iterations == sol.iterations
    its = got.iterations
    assert_close(got.telemetry.data_energy[:its], energies[:, 0], rtol=2e-4, atol=1e-8)
    assert_close(got.telemetry.smoothing_energy[:its], energies[:, 1], rtol=2e-4, atol=1e-8)


def _solves(seed, dtype=torch.float32):
    pair = _pair(seed)
    (canonical, ref_canonical), (live, ref_live) = (
        _tsdfs(d, pair.camera, dtype) for d in (pair.canonical_depth, pair.live_depth))
    got = solve_single_level(canonical, live, PARAMS)
    warped = warp_field_cm(live, to_component_major(got.warp))
    sol = solver2d.solve(ref_canonical, ref_live, solver2d.params(SOLVER), dtype=dtype)
    return got, warped, sol, ref_live


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_matches_the_reference(seed):
    got, warped, sol, live = _solves(seed)
    assert 10 < got.iterations < PARAMS.max_iterations and got.converged
    _compare(got, warped, sol, live)


def test_bfloat16_reference_fails_the_comparison():
    """The reference in bfloat16 (the next precision below the float32 the
    configuration states) in the program's place: the comparison fails."""
    got, warped, sol, live = _solves(0, torch.bfloat16)
    with pytest.raises(AssertionError):
        _compare(got, warped, sol, live)


@pytest.mark.parametrize("stated", [
    dict(level_set_term_weight=0.1), dict(sobolev_smoothing=True),
    dict(adaptive_learning_rate=True), dict(smoothing_mode="killing"),
    dict(band_union_only=False),
])
def test_reference_refuses_terms_the_configuration_does_not_state(stated):
    with pytest.raises(ValueError, match="2D reference"):
        solver2d.params({**SOLVER, **stated})
