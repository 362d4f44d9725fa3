"""Parity of the port's fusion (``models/fusion.py``) with the JAX
package's: ``blend`` and ``init_state`` on seeded fields, and
``fuse_sequence`` on ``tests/test_fusion.py``'s small sequence ((32, 32, 24),
4 frames, its Killing solver), flat and hierarchical (3 levels), with and
without the warm start, JAX on its golden path (the exact gather).

Tolerances: ``blend`` and ``init_state`` 1e-7 (one division a voxel);
per-frame iteration counts exactly; the canonical and the final warp within
the solve's rtol 3e-4 atol 3e-6 (tests/test_fused_gradient.py's solver
tolerances). A weight counts whether a warped value lies inside
|Φ| < 1 − 1e-5, so a value closer to that bound than the two packages'
warped values differ (in that frame) may fall on either side in the two:
the weights exactly, the canonical within tolerance and ``band_voxels``
are compared away from such voxels, which are counted and bounded."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import synthetic as jsynthetic
from levelsetfusion_tpu.models import fusion as jfusion
from levelsetfusion_tpu.models import hierarchical as jhierarchical
from levelsetfusion_tpu.models.params import SmoothingMode as JMode
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu.ops.interpolation import warp_field as jwarp_field
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d as jtsdf
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models import fusion, hierarchical
from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.ops.interpolation import warp_field
from tests.torch_parity import assert_close, n, t

SHAPE, VOXEL, OFFSET = (32, 32, 24), 0.008, (-16, -16, 42)
SOLVER = dict(max_iterations=60, learning_rate=0.5, smoothing_term_weight=0.1,
              convergence_threshold=2e-3, adaptive_learning_rate=True)
SEQ = dict(num_frames=4, width=48, height=48, blob_radius_px=10.0, blob_height=0.05,
           drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1)
BOUND = np.float32(1.0 - 1e-5)
MAX_NEAR = 0.01  # share of voxels near the bound in some frame (41 of 24576 here)


def _configs(**solver):
    kw = {**SOLVER, **solver}
    jcfg = jfusion.FusionPipelineConfig(
        grid=JGrid(shape=SHAPE, voxel_size=VOXEL, offset=OFFSET), hierarchical=False,
        solver=JSolver(smoothing_mode=JMode.KILLING, **kw))
    tcfg = fusion.FusionPipelineConfig(
        grid=GridSpec(shape=SHAPE, voxel_size=VOXEL, offset=OFFSET), hierarchical=False,
        solver=SolverParams(smoothing_mode=SmoothingMode.KILLING, **kw))
    return jcfg, tcfg


def _fields(seed, shape=(9, 7, 5)):
    """TSDF-like fields with exact ±1 runs (truncated voxels) and values at
    the band's bound."""
    rng = np.random.default_rng(seed)
    a, b = (np.clip(rng.standard_normal(shape) * 0.8, -1, 1).astype(np.float32)
            for _ in range(2))
    a.flat[::11] = np.float32(BOUND)
    b.flat[::13] = -1.0
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_and_init_state_match_jax(seed):
    first, live = _fields(seed)
    jstate, tstate = jfusion.init_state(jnp.asarray(first)), fusion.init_state(t(first))
    for got, want in zip(tstate, jstate):
        assert_close(got, want, 0.0, 1e-7)
    for step in range(3):  # weights accumulate past 1
        jstate = jfusion.blend(jstate, jnp.asarray(live) * (0.5 + 0.2 * step))
        tstate = fusion.blend(tstate, t(live) * (0.5 + 0.2 * step))
        for got, want in zip(tstate, jstate):
            assert_close(got, want, 0.0, 1e-7)


def test_blend_weighted_average():
    """tests/test_fusion.py's hand-computed case."""
    state = fusion.init_state(torch.tensor([[0.5, 1.0], [-0.5, 0.2]]))
    np.testing.assert_array_equal(n(state.weights), [[1, 0], [1, 1]])
    new = fusion.blend(state, torch.tensor([[0.0, 0.4], [-0.5, 1.0]]))
    np.testing.assert_allclose(n(new.canonical), [[0.25, 0.4], [-0.5, 0.2]], atol=1e-6)
    np.testing.assert_array_equal(n(new.weights), [[2, 1], [2, 1]])


def _collect(frames):
    """A frame callback that keeps each frame's warp."""
    def cb(t_, state, warp, report=None, solver=None):
        frames[t_] = np.array(n(warp))
    return cb


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's fusion of the small sequence (pipelined, and the
    port's serial loop), with every frame's warp."""
    seq = jsynthetic.snoopy_style_sequence_3d(**SEQ)
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    jcfg, tcfg = _configs()
    jwarps, twarps, swarps = {}, {}, {}
    want = jfusion.fuse_sequence(seq.frames, seq.camera, jcfg, frame_callback=_collect(jwarps))
    got = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu",
                               frame_callback=_collect(twarps))
    serial = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu",
                                  frame_callback=_collect(swarps), pipelined=False)
    return seq, jcfg, (want, jwarps), (got, twarps), (serial, swarps)


def _near_bound(seq, jcfg, jwarps, twarps):
    """Voxels whose warped live value lies, in some fused frame, closer to
    the band's bound than JAX's and the port's warped values differ in that
    frame: the voxels whose weight may fall either way."""
    near = np.zeros(SHAPE, bool)
    for t_ in jwarps:
        live = jtsdf(jnp.asarray(seq.frames[t_]), seq.camera, jcfg.grid)
        want = np.asarray(jwarp_field(live, jnp.asarray(jwarps[t_])))
        got = n(warp_field(t(live), t(twarps[t_])))
        window = np.max(np.abs(got - want))
        near |= np.abs(np.abs(want) - BOUND) <= window
    return near


def test_fuse_sequence_matches_jax(runs):
    seq, jcfg, (want, jwarps), (got, twarps), _ = runs
    assert len(got.reports) == len(want.reports) == 3
    near = _near_bound(seq, jcfg, jwarps, twarps)
    assert near.mean() <= MAX_NEAR, near.mean()
    far = ~near
    for g, w in zip(got.reports, want.reports):
        assert g.frame_index == w.frame_index
        assert g.solver_iterations == int(w.solver_iterations) > 0
        assert abs(g.band_voxels - w.band_voxels) <= near.sum()
        np.testing.assert_allclose(g.final_data_energy, w.final_data_energy, rtol=2e-4)
        np.testing.assert_allclose(g.max_abs_displacement, w.max_abs_displacement,
                                   rtol=3e-4, atol=3e-6)
        assert (g.pallas_max_displacement, g.contract_violations) == (0, ())
        assert w.pallas_max_displacement == 0 and not w.contract_violations
    np.testing.assert_array_equal(n(got.state.weights)[far], np.asarray(want.state.weights)[far])
    np.testing.assert_allclose(n(got.state.canonical)[far],
                               np.asarray(want.state.canonical)[far], rtol=3e-4, atol=3e-6)
    assert_close(got.final_warp, want.final_warp, rtol=3e-4, atol=3e-6)
    assert got.final_warp.shape == (*SHAPE, 3)


def test_pipelined_equals_serial(runs):
    """The pipelined loop reads frame t's stats after dispatching frame t + 1
    and gives the serial loop's reports, states and warps exactly."""
    _, _, _, (got, twarps), (serial, swarps) = runs
    assert got.reports == serial.reports
    for a, b in zip((*got.state, got.final_warp), (*serial.state, serial.final_warp)):
        np.testing.assert_array_equal(n(a), n(b))
    assert twarps.keys() == swarps.keys() == {1, 2, 3}
    for k in twarps:
        np.testing.assert_array_equal(twarps[k], swarps[k])


def test_fuse_frame_equals_sequence_frame(runs):
    """``fuse_frame`` from frame 1's depth (as the CLI's resume runs it)
    gives fuse_sequence's first report."""
    seq, _, _, (got, twarps), _ = runs
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    _, tcfg = _configs()
    state = fusion.init_state(fusion._tsdf(tseq.frames[0], tseq.camera, tcfg, torch.device("cpu")))
    _, warp, report, solver = fusion.fuse_frame(
        state, None, torch.zeros((*SHAPE, 3)), tcfg.solver, tcfg, 1,
        depth=tseq.frames[1], camera=tseq.camera)
    assert report == got.reports[0] and solver is tcfg.solver
    np.testing.assert_array_equal(n(warp), twarps[1])


def test_callback_gets_reports_and_the_frame_state():
    tseq = synthetic.snoopy_style_sequence_3d(**{**SEQ, "num_frames": 3})
    _, tcfg = _configs(max_iterations=4)
    seen = []

    def cb(t_, state, warp, report, solver):
        seen.append((t_, report.frame_index, report.band_voxels,
                     int((torch.abs(state.canonical) < 1 - 1e-5).sum()), solver))

    res = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu", frame_callback=cb)
    assert [s[:2] for s in seen] == [(1, 1), (2, 2)]
    assert all(s[2] == s[3] and s[4] is tcfg.solver for s in seen)
    assert [r.solver_iterations for r in res.reports] == [4, 4]


def _hier_configs(**kw):
    jcfg, tcfg = _configs()
    return (dataclasses.replace(jcfg, hierarchical=True, **kw),
            dataclasses.replace(tcfg, hierarchical=True, **kw))


@pytest.fixture(scope="module")
def hier_runs():
    """JAX's and the port's hierarchical fusion (3 levels: (8, 8, 6),
    (16, 16, 12), (32, 32, 24)) of the small sequence, with every frame's
    warp; the port's SolveLoops counted."""
    seq = jsynthetic.snoopy_style_sequence_3d(**SEQ)
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    jcfg, tcfg = _hier_configs()
    jwarps, twarps = {}, {}
    want = jfusion.fuse_sequence(seq.frames, seq.camera, jcfg, frame_callback=_collect(jwarps))
    got = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu",
                               frame_callback=_collect(twarps))
    return seq, jcfg, (want, jwarps), (got, twarps)


def test_hierarchical_fusion_matches_jax(hier_runs):
    """The hierarchical branch (JAX's serial loop; statistics of the finest
    level): the same per-frame iterations, and the flat path's rules for
    the rest."""
    seq, jcfg, (want, jwarps), (got, twarps) = hier_runs
    assert len(got.reports) == len(want.reports) == 3
    near = _near_bound(seq, jcfg, jwarps, twarps)
    assert near.mean() <= MAX_NEAR, near.mean()
    far = ~near
    for g, w in zip(got.reports, want.reports):
        assert g.frame_index == w.frame_index
        assert g.solver_iterations == int(w.solver_iterations) > 0
        assert abs(g.band_voxels - w.band_voxels) <= near.sum()
        np.testing.assert_allclose(g.final_data_energy, w.final_data_energy, rtol=2e-4)
        np.testing.assert_allclose(g.max_abs_displacement, w.max_abs_displacement,
                                   rtol=3e-4, atol=3e-6)
    for k in jwarps:
        assert_close(twarps[k], jwarps[k], rtol=3e-4, atol=3e-6)
    np.testing.assert_array_equal(n(got.state.weights)[far], np.asarray(want.state.weights)[far])
    np.testing.assert_allclose(n(got.state.canonical)[far],
                               np.asarray(want.state.canonical)[far], rtol=3e-4, atol=3e-6)
    assert_close(got.final_warp, want.final_warp, rtol=3e-4, atol=3e-6)


def test_fusion_without_warm_start_matches_jax():
    """``warm_start=False``: every frame's solve starts from zero, on both
    paths (per-frame iterations as JAX's)."""
    seq = jsynthetic.snoopy_style_sequence_3d(**SEQ)
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    for hierarchical in (True, False):
        jcfg, tcfg = (dataclasses.replace(c, hierarchical=hierarchical, warm_start=False)
                      for c in _configs(max_iterations=30))
        want = jfusion.fuse_sequence(seq.frames, seq.camera, jcfg)
        got = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu")
        assert [r.solver_iterations for r in got.reports] == [
            int(r.solver_iterations) for r in want.reports]
        assert_close(got.final_warp, want.final_warp, rtol=3e-4, atol=3e-6)


def _counted_loops(monkeypatch):
    """``single_level.SolveLoop`` patched to append each new loop's shape to
    the list returned."""
    from levelsetfusion_tpu_torch.models import single_level

    made = []

    class Counted(single_level.SolveLoop):
        def __init__(self, shape, *args, **kw):
            made.append(tuple(shape))
            super().__init__(shape, *args, **kw)

    monkeypatch.setattr(single_level, "SolveLoop", Counted)
    return made


def _first_frame(tcfg, tseq):
    """``fuse_frame`` of frame 1 onto frame 0's state, from a zero warp."""
    state = fusion.init_state(fusion._tsdf(tseq.frames[0], tseq.camera, tcfg,
                                           torch.device("cpu")))
    return fusion.fuse_frame(state, None, torch.zeros((*SHAPE, 3)), tcfg.solver, tcfg, 1,
                             depth=tseq.frames[1], camera=tseq.camera)


def test_hierarchical_keeps_one_loop_per_level_shape(hier_runs, monkeypatch):
    """A hierarchical sequence makes one SolveLoop per level shape (so on
    CUDA each level's graph is captured once), and a ``fuse_frame`` after
    it builds nothing: it runs in the sequence's kept loops, the last level
    first, and gives the sequence's first frame."""
    from levelsetfusion_tpu_torch.models import single_level

    _, _, _, (got, twarps) = hier_runs
    single_level.release_kept_loops()
    made = _counted_loops(monkeypatch)
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    _, tcfg = _hier_configs()
    again = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu")
    assert made == [(8, 8, 6), (16, 16, 12), (32, 32, 24)]
    assert again.reports == got.reports
    _, warp, report, _ = _first_frame(tcfg, tseq)
    kept = single_level._kept_loops()[torch.device("cpu")]
    assert report == got.reports[0] and len(made) == 3
    assert [loop.shape for loop in kept] == made[::-1]
    np.testing.assert_array_equal(n(warp), twarps[1])


@pytest.mark.parametrize("hierarchical", [False, True])
def test_fuse_frame_of_another_solver_releases_the_kept_loops(hierarchical):
    """Both branches look a solve shape's loop up in ``loop_for`` the same
    way: kept loops built for other parameters are released, not reused;
    the frame builds and keeps its own, and equals a frame run with
    nothing kept exactly."""
    from levelsetfusion_tpu_torch.models import single_level

    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    _, tcfg = _hier_configs() if hierarchical else _configs()
    cpu = torch.device("cpu")
    shapes = [(8, 8, 6), (16, 16, 12), SHAPE] if hierarchical else [SHAPE]
    single_level.release_kept_loops()
    stale = [single_level.loop_for(shape, tcfg.solver.replace(max_iterations=3), cpu)
             for shape in shapes]
    got = _first_frame(tcfg, tseq)
    kept = single_level._kept_loops()[cpu]
    assert sorted(loop.shape for loop in kept) == sorted(shapes)
    assert all(loop.params == tcfg.solver and all(loop is not s for s in stale)
               for loop in kept)
    single_level.release_kept_loops()
    want = _first_frame(tcfg, tseq)
    assert got[2] == want[2]
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)


def test_fuse_sequence_reuses_a_solve_single_levels_loop(runs, monkeypatch):
    """A flat sequence after a ``solve_single_level`` call of its shape and
    solver builds no loop: every frame runs in the loop that call left
    kept, with the reports and final warp of a sequence run alone."""
    from levelsetfusion_tpu_torch.models import single_level

    _, _, _, (want, _), _ = runs
    tseq = synthetic.snoopy_style_sequence_3d(**SEQ)
    _, tcfg = _configs()
    single_level.release_kept_loops()
    c, l = (fusion._tsdf(d, tseq.camera, tcfg, torch.device("cpu")) for d in tseq.frames[:2])
    single_level.solve_single_level(c, l, tcfg.solver)
    loop, = single_level._kept_loops()[torch.device("cpu")]
    made = _counted_loops(monkeypatch)
    got = fusion.fuse_sequence(tseq.frames, tseq.camera, tcfg, device="cpu")
    assert made == [] and single_level._kept_loops()[torch.device("cpu")] == [loop]
    assert got.reports == want.reports
    assert torch.equal(got.final_warp, want.final_warp)


@pytest.mark.parametrize("name", ["fuse_frame", "solve_hierarchical",
                                  "solve_hierarchical_from_depth"])
def test_signature_matches_jax(name):
    """The public solves take their JAX twins' parameters, by name and kind,
    and no more: no caller hands in a solve loop."""
    port = fusion if name == "fuse_frame" else hierarchical
    twin = jfusion if name == "fuse_frame" else jhierarchical

    def params(fn):
        return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]

    assert params(getattr(port, name)) == params(getattr(twin, name))


def test_pipeline_config_matches_jax():
    """The config's fields and defaults are JAX's, less the clamp's
    ``auto_raise_displacement``."""
    tfields = {f.name: f.default for f in dataclasses.fields(fusion.FusionPipelineConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(jfusion.FusionPipelineConfig)}
    assert set(tfields) == set(jfields) - {"auto_raise_displacement"}
    for name in ("narrow_band_width_voxels", "hierarchical", "levels", "warm_start"):
        assert tfields[name] == jfields[name], name
