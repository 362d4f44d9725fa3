"""The port's coarse-to-fine 2D path (config2's:
``models/hierarchical.py::solve_hierarchical_from_depth`` on EWA depth
pyramids, the Sobolev 2D step, ``ops/pyramid.py::prolongate_warp``) against
the benchmark's plain hierarchical reference (``portbench/reference/
hier2d.py``: plain torch from the definitions, nothing of the port), on the
CPU, at a small size (a 32 x 16 grid at 4 mm before a 32 px scanline at
8 cm, 2 levels) and at config2's (96 x 64, 3 levels, the 128 px scanline at
40 cm), on seeded bump-on-a-wall pairs (``io/synthetic.py::
bump_wall_pair_2d``) with config2's solver (data + Tikhonov 0.2, the 7-tap
Sobolev filter at 0.1, rate 1.0 fixed, gate 1e-3, at most 60 iterations a
level).

Tolerances, each with its reason:
- every TSDF of both pyramids (BASIC at the finest level, EWA above): the
  rule of ``test_torch_core.py``'s TSDF tests, |Δ| > 1e-5 on at most 0.5%
  of voxels, since a rounding in the projection may move a voxel across a
  pixel boundary and an EWA weight is an ``exp`` of float32 values;
- the prolongated warp: atol 2e-6 on values within ±8 voxels, a few float32
  ulps: both sides interpolate with float32 weights in another order;
- one Sobolev step: atol 1e-6 on the new warp, the same terms summed in
  another order, once;
- the whole solve: each level's iterations exactly, since a level stops on
  a float32 norm against the float32 threshold on both sides; the finest
  warp and the warped field rtol 3e-4, atol 3e-6, the solver tolerances of
  ``test_torch_single_level.py``, since up to 180 iterations carry the
  rounding.
The same comparison fails where the reference runs in bfloat16.
"""

import json
import types

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models.hierarchical import (
    build_pyramid_from_depth,
    solve_hierarchical_from_depth,
)
from levelsetfusion_tpu_torch.models.params import HierarchicalParams
from levelsetfusion_tpu_torch.models.single_level import fused_step_kwargs
from levelsetfusion_tpu_torch.ops.kernels import step2d
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.ops.pyramid import prolongate_warp
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod, generate_tsdf_2d
from levelsetfusion_tpu_torch.utils.config import PRESETS
from portbench.reference import hier2d
from tests.torch_parity import assert_close

CONFIG2 = PRESETS["config2_2d_hierarchical"]


def _solver_dict():
    """config2's ``solver`` as its configuration file states it."""
    return json.loads(CONFIG2.to_json())["solver"]


SIZES = {
    # 32 x 16 voxels at 4 mm from z = 48 mm, a 32 px scanline, a wall at 8 cm.
    "small": dict(grid=GridSpec(shape=(32, 16), voxel_size=0.004, offset=(-16, 12)),
                  band=8, levels=2, width=32, wall=0.08, height=0.008, radius=(4.0, 6.0),
                  shift=(1.0, 3.0)),
    # config2's grid, band, levels and scanline; the traffic's wide shifts.
    "config2": dict(grid=GridSpec(shape=CONFIG2.grid_shape, voxel_size=CONFIG2.voxel_size,
                                  offset=CONFIG2.grid_offset),
                    band=CONFIG2.narrow_band_width_voxels, levels=CONFIG2.levels, width=128,
                    wall=0.4, height=0.04, radius=(20.0, 20.0), shift=(4.0, 12.0)),
}
SEEDS = range(3)


def _pair(size, seed):
    """A seeded bump-on-a-wall scanline pair at ``size``: the live bump
    shifted by a seeded amount in the size's range, alternating in sign."""
    s, rng = SIZES[size], np.random.default_rng(seed)
    shift = float(rng.uniform(*s["shift"])) * (-1 if seed % 2 else 1)
    return synthetic.bump_wall_pair_2d(
        width=s["width"], wall_depth=s["wall"], bump_height=s["height"],
        bump_radius_px=float(rng.uniform(*s["radius"])), live_shift_px=shift,
        live_height_scale=float(rng.uniform(0.9, 1.1)))


def _cam(camera):
    return types.SimpleNamespace(fx=camera.fx, cx=camera.cx, width=camera.image_width)


def _grids(size):
    s = SIZES[size]
    g = s["grid"]
    return hier2d.levels(g.shape, g.voxel_size, g.offset, s["band"], s["levels"])


def test_reference_grids_are_the_programs():
    """The reference's levels are ``GridSpec.coarsened(2)``'s, with the band
    halved a level as ``build_pyramid_from_depth`` halves it."""
    g = SIZES["config2"]["grid"]
    program = [g, g.coarsened(2), g.coarsened(2).coarsened(2)]
    for level, want in zip(_grids("config2"), program, strict=True):
        assert (level.shape, level.offset) == (want.shape, want.offset)
        assert level.voxel_size == pytest.approx(want.voxel_size, rel=1e-12)
    assert [lv.shape for lv in _grids("config2")] == [(96, 64), (48, 32), (24, 16)]
    assert [lv.band_voxels for lv in _grids("config2")] == [20, 10, 5]


def _fields_match(got, want):
    off = torch.abs(got - want.float()) > 1e-5
    assert off.float().mean() <= 0.005, off.float().mean()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
def test_pyramids_match_the_reference(size, seed):
    """Each level of both pyramids: BASIC at the finest, EWA above."""
    pair, s = _pair(size, seed), SIZES[size]
    for depth in (pair.canonical_depth, pair.live_depth):
        row = torch.from_numpy(depth)
        got, _ = build_pyramid_from_depth(row, pair.camera, s["grid"], s["levels"], s["band"])
        want = hier2d.pyramid(row, _cam(pair.camera), _grids(size))
        assert len(got) == len(want) == s["levels"]
        for g, w in zip(got[::-1], want):
            assert g.shape == w.shape
            assert torch.any(torch.abs(w) < 1.0) and torch.any(w == 1.0)
            _fields_match(g, w)


def test_ewa_level_of_an_invalid_stretch():
    """Pixels with no depth: voxels whose taps are all invalid get +1, and
    the others average only the valid taps."""
    pair = _pair("small", 0)
    depth = pair.live_depth.copy()
    depth[8:20] = 0.0
    row = torch.from_numpy(depth)
    level = _grids("small")[1]
    grid = SIZES["small"]["grid"].coarsened(2)
    got = generate_tsdf_2d(row, pair.camera, grid, narrow_band_width_voxels=level.band_voxels,
                           method=GenerationMethod.EWA_IMAGE)
    want = hier2d.ewa(row, _cam(pair.camera), level)
    _fields_match(got, want)
    assert torch.any((want == 1.0) & (torch.abs(hier2d.ewa(torch.from_numpy(pair.live_depth),
                                                           _cam(pair.camera), level)) < 1.0))


@pytest.mark.parametrize("shape", [(12, 8), (24, 16), (48, 32)])
def test_prolongation_matches_the_reference(shape):
    warp = torch.from_numpy(np.random.default_rng(shape[0]).uniform(
        -4, 4, (*shape, 2)).astype(np.float32))
    got = prolongate_warp(warp)
    want = hier2d.prolongate(to_component_major(warp), tuple(2 * s for s in shape))
    assert got.shape == (2 * shape[0], 2 * shape[1], 2)
    assert_close(to_component_major(got), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("size", SIZES)
def test_sobolev_step_matches_the_reference(size):
    """One 2D step with config2's terms and filter from a seeded warp."""
    pair, s = _pair(size, 1), SIZES[size]
    canonical, live = (generate_tsdf_2d(torch.from_numpy(d), pair.camera, s["grid"],
                                        narrow_band_width_voxels=s["band"])
                       for d in (pair.canonical_depth, pair.live_depth))
    warp = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (2, *s["grid"].shape)).astype(np.float32))
    kw = fused_step_kwargs(CONFIG2.solver)
    assert len(kw["taps"]) == 7
    rate = torch.tensor(1.0)
    got, _ = step2d.step2d(live, canonical, warp, rate, **kw)
    p = hier2d.params(_solver_dict())
    assert p.taps == kw["taps"]
    want, longest = hier2d.step(canonical, live, warp, rate, p)
    assert_close(got, want, rtol=0, atol=1e-6)
    assert float(longest) > 1e-3  # the step moves the warp


def _solves(size, seed, dtype=torch.float32):
    """(the program's result and warped field, the reference's solution)."""
    pair, s = _pair(size, seed), SIZES[size]
    hp = HierarchicalParams(levels=s["levels"], base=CONFIG2.solver)
    rows = [torch.from_numpy(d) for d in (pair.canonical_depth, pair.live_depth)]
    got = solve_hierarchical_from_depth(*rows, pair.camera, s["grid"], hp,
                                        narrow_band_width_voxels=s["band"])
    live = generate_tsdf_2d(rows[1], pair.camera, s["grid"], narrow_band_width_voxels=s["band"])
    warped = warp_field_cm(live, to_component_major(got.warp))
    sol = hier2d.solve(*rows, _cam(pair.camera), _grids(size), hier2d.params(_solver_dict()),
                       dtype=dtype)
    return got, warped, sol


def _compare(got, warped, sol):
    assert [r.iterations for r in got.level_results] == sol.iterations
    assert_close(to_component_major(got.warp), sol.warp.float(), rtol=3e-4, atol=3e-6)
    assert_close(warped, sol.warped.float(), rtol=3e-4, atol=3e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
def test_solve_matches_the_reference(size, seed):
    got, warped, sol = _solves(size, seed)
    assert len(sol.iterations) == SIZES[size]["levels"]
    assert all(0 < it <= CONFIG2.solver.max_iterations for it in sol.iterations)
    assert float(torch.abs(sol.warp).max()) > 0.5  # the levels moved the warp
    _compare(got, warped, sol)


@pytest.mark.parametrize("size", SIZES)
def test_bfloat16_reference_fails_the_comparison(size):
    """The reference in bfloat16 (the next precision below the float32 the
    configuration states) in the program's place: the comparison fails."""
    got, warped, sol = _solves(size, 0, torch.bfloat16)
    with pytest.raises(AssertionError):
        _compare(got, warped, sol)


@pytest.mark.parametrize("stated", [
    dict(level_set_term_weight=0.1), dict(adaptive_learning_rate=True),
    dict(smoothing_mode="killing"), dict(band_union_only=False),
])
def test_reference_refuses_terms_the_configuration_does_not_state(stated):
    with pytest.raises(ValueError, match="2D reference"):
        hier2d.params({**_solver_dict(), **stated})
