"""Parity of the port's hierarchical coarse-to-fine solve
(``models/hierarchical.py``) with the JAX package's: config2's problem on a
block-mean pyramid and on an EWA depth pyramid, a warm start downsampled to
the coarsest level, and the per-level loops ``loop_for`` keeps.

Tolerances: each level's iteration count and ``converged`` exactly; its
warp and max |u| rtol 3e-4 atol 3e-6 and telemetry rtol 2e-4 atol 1e-8
(tests/test_fused_gradient.py's solver tolerances, as in
tests/test_torch_single_level.py); EWA pyramid levels by the rule of
tests/test_torch_core.py (|Δ| > 1e-5 on at most 0.5% of voxels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core.camera import PinholeCamera as JCam
from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import synthetic as jsyn
from levelsetfusion_tpu.models import hierarchical as jh
from levelsetfusion_tpu.models import params as jparams
from levelsetfusion_tpu.ops.tsdf import GenerationMethod as JMethod
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_2d as jtsdf2
from levelsetfusion_tpu_torch.core.camera import PinholeCamera
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.models import hierarchical as th
from levelsetfusion_tpu_torch.models import params as tparams
from levelsetfusion_tpu_torch.models.single_level import _kept_loops, release_kept_loops
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod
from tests.test_torch_single_level import _compare
from tests.torch_parity import assert_close, n, t

CONFIG2 = dict(shape=(96, 64), voxel_size=0.004, offset=(-48, 75))
BASE = dict(max_iterations=60, learning_rate=1.0, convergence_threshold=1e-3,
            sobolev_smoothing=True)


def _params(levels=3, **kw):
    kw = {**BASE, **kw}
    return (jparams.HierarchicalParams(levels=levels, base=jparams.SolverParams(**kw)),
            tparams.HierarchicalParams(levels=levels, base=tparams.SolverParams(**kw)))


def _pair(shift, grid=CONFIG2):
    """The bump pair's depths and its BASIC TSDFs (JAX's; the port's TSDF
    parity is tests/test_torch_core.py's)."""
    pair = jsyn.bump_wall_pair_2d(width=128, bump_height=0.04, bump_radius_px=20.0,
                                  live_shift_px=shift)
    g = JGrid(**grid)
    canonical, live = (np.asarray(jtsdf2(jnp.asarray(d), pair.camera, g))
                       for d in (pair.canonical_depth, pair.live_depth))
    return pair, canonical, live


def _compare_levels(got, want, max_iterations):
    assert len(got.level_results) == len(want.level_results)
    for g, w in zip(got.level_results, want.level_results):
        _compare(g, w, max_iterations)
    assert_close(got.warp, want.warp, rtol=3e-4, atol=3e-6)


def test_hierarchical_defaults_match_jax():
    j, p = jparams.HierarchicalParams(), tparams.HierarchicalParams()
    assert p.levels == j.levels == 3
    for name in ("max_iterations", "convergence_threshold", "sobolev_smoothing",
                 "learning_rate"):
        assert getattr(p.base, name) == getattr(j.base, name), name
    assert p.replace(levels=2).levels == 2


def test_block_mean_config2_matches_jax():
    """config2's problem (8 px of motion, 3 levels, Sobolev) on block-mean
    pyramids, at full size."""
    _, canonical, live = _pair(8.0)
    jp, tp = _params()
    want = jh.solve_hierarchical(jnp.asarray(canonical), jnp.asarray(live), jp)
    got = th.solve_hierarchical(t(canonical), t(live), tp)
    assert [tuple(r.warp.shape) for r in got.level_results] == [(24, 16, 2), (48, 32, 2),
                                                                (96, 64, 2)]
    _compare_levels(got, want, BASE["max_iterations"])


def test_warm_start_matches_jax():
    """A finest-level warm start, block-mean downsampled per component and
    halved to the coarsest level, with the loop stopping before its cap."""
    _, canonical, live = _pair(4.0, dict(shape=(64, 32), voxel_size=0.004, offset=(-32, 85)))
    warp = (np.random.default_rng(7).standard_normal((64, 32, 2)) * 0.4).astype(np.float32)
    jp, tp = _params(levels=2, max_iterations=40, sobolev_smoothing=False,
                     convergence_threshold=5e-3)
    assert_close(th.downsample_warp(t(warp), 1),
                 jnp.stack([jh.pyramid.downsample2x_mean(jnp.asarray(warp)[..., c])
                            for c in range(2)], -1) * 0.5, 0.0, 1e-7)
    want = jh.solve_hierarchical(jnp.asarray(canonical), jnp.asarray(live), jp,
                                 initial_warp=jnp.asarray(warp))
    got = th.solve_hierarchical(t(canonical), t(live), tp, initial_warp=t(warp))
    assert any(r.converged for r in got.level_results)
    _compare_levels(got, want, 40)


def test_ewa_depth_pyramid_matches_jax():
    """The EWA pyramid regenerated from depth (config2's ``ewa_depth``):
    its levels and the solve over them."""
    pair, _, _ = _pair(6.0)
    g, tg = JGrid(**CONFIG2), GridSpec(**CONFIG2)
    jpyr, jgrids = jh.build_pyramid_from_depth(jnp.asarray(pair.canonical_depth), pair.camera,
                                               g, levels=3)
    tpyr, tgrids = th.build_pyramid_from_depth(t(pair.canonical_depth), pair.camera, tg,
                                               levels=3)
    assert [tuple(p.shape) for p in tpyr] == [(24, 16), (48, 32), (96, 64)]
    assert [(x.shape, x.voxel_size, x.offset) for x in tgrids] == [
        (x.shape, x.voxel_size, x.offset) for x in jgrids]
    for a, b in zip(tpyr, jpyr):
        off = np.abs(n(a) - np.asarray(b)) > 1e-5
        assert off.mean() <= 0.005, off.mean()
    assert float((torch.abs(tpyr[0]) < 1).float().mean()) > 0.1
    jp, tp = _params(max_iterations=40)
    want = jh.solve_hierarchical_from_depth(jnp.asarray(pair.canonical_depth),
                                            jnp.asarray(pair.live_depth), pair.camera, g, jp)
    got = th.solve_hierarchical_from_depth(t(pair.canonical_depth), t(pair.live_depth),
                                           pair.camera, tg, tp)
    _compare_levels(got, want, 40)


def test_ewa_depth_pyramid_3d_matches_jax():
    """A 3D EWA pyramid with another coarse method and band width."""
    cam_kw = dict(fx=48.0, fy=48.0, cx=24.0, cy=24.0, image_width=48, image_height=48)
    depth = jsyn.blob_wall_depth_3d(JCam(**cam_kw), blob_radius_px=10.0, blob_height=0.06)
    grid = dict(shape=(16, 16, 12), voxel_size=0.016, offset=(-8, -8, 21))
    jpyr, _ = jh.build_pyramid_from_depth(jnp.asarray(depth), JCam(**cam_kw), JGrid(**grid),
                                          levels=2, narrow_band_width_voxels=10,
                                          coarse_method=JMethod.EWA_TSDF)
    tpyr, _ = th.build_pyramid_from_depth(t(depth), PinholeCamera(**cam_kw), GridSpec(**grid),
                                          levels=2, narrow_band_width_voxels=10,
                                          coarse_method=GenerationMethod.EWA_TSDF)
    for a, b in zip(tpyr, jpyr):
        assert a.shape == b.shape
        off = np.abs(n(a) - np.asarray(b)) > 1e-5
        assert off.mean() <= 0.005, off.mean()


def test_loops_serve_a_sequence_of_solves():
    """``loop_for`` keeps one SolveLoop per level shape, reused by the next
    solve with the results of new loops; a solve of other parameters
    releases them and keeps its own."""
    _, canonical, live = _pair(4.0, dict(shape=(32, 16), voxel_size=0.008, offset=(-16, 42)))
    _, tp = _params(max_iterations=12)
    cpu = torch.device("cpu")
    release_kept_loops()
    first = th.solve_hierarchical(t(canonical), t(live), tp)
    kept = list(_kept_loops()[cpu])
    assert [loop.shape for loop in kept] == [(32, 16), (16, 8), (8, 4)]
    again = th.solve_hierarchical(t(live), t(canonical), tp)
    assert len(_kept_loops()[cpu]) == 3
    assert all(a is b for a, b in zip(_kept_loops()[cpu], kept))
    release_kept_loops()
    fresh = th.solve_hierarchical(t(live), t(canonical), tp)
    for a, b in zip(again.level_results, fresh.level_results):
        assert a.iterations == b.iterations
        np.testing.assert_array_equal(n(a.warp), n(b.warp))
    assert first.level_results[0].iterations > 0
    other = tp.replace(base=tp.base.replace(max_iterations=3))
    th.solve_hierarchical(t(canonical), t(live), other)
    assert len(_kept_loops()[cpu]) == 3
    assert all(loop.params == other.base for loop in _kept_loops()[cpu])


@pytest.mark.parametrize("shape", [(32, 16), (16, 8, 8)])
def test_last_level_leads_the_kept_loops(shape, monkeypatch):
    """After a three-level solve the kept loops are its levels', the loop
    of the last call first: the finest level's, then the coarser ones."""
    from levelsetfusion_tpu_torch.models import single_level

    solved = []

    class Recorded(single_level.SolveLoop):
        def solve(self, *args, **kw):
            solved.append(self)
            return super().solve(*args, **kw)

    monkeypatch.setattr(single_level, "SolveLoop", Recorded)
    rng = np.random.default_rng(5)
    canonical, live = (np.tanh(rng.standard_normal(shape)).astype(np.float32)
                       for _ in range(2))
    _, tp = _params(max_iterations=6)
    release_kept_loops()
    th.solve_hierarchical(t(canonical), t(live), tp)
    kept = _kept_loops()[torch.device("cpu")]
    assert kept[0] is solved[-1] and kept == solved[::-1]
    assert [loop.shape for loop in kept] == [shape, *(
        tuple(s // f for s in shape) for f in (2, 4))]
