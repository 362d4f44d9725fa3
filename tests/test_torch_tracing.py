"""The port's own spans and counters (``utils/profiling.py``): with no
profiler running a span is one check and a shared no-op context and a count
adds nothing; under ``torch.profiler`` each span appears where the program
says it does (the solve loop, the fusion frame, the native prefetcher, the
halo exchange, the 2D and 3D TSDF, a hierarchical solve's pyramids and
hand-offs), ``spans()`` totals them,
``halo.bytes_sent`` counts the bytes handed to ``isend``, each graph replay
adds its chunk's kernels and iterations (and its 2D steps, where it has
them), and the CLI's ``--profile`` writes the counters into its summary."""

import collections
import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch import cli
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import depth, native_loader, synthetic
from levelsetfusion_tpu_torch.models import fusion, hierarchical
from levelsetfusion_tpu_torch.models.params import (
    HierarchicalParams,
    SmoothingMode,
    SolverParams,
)
from levelsetfusion_tpu_torch.models.single_level import (
    CHECK_EVERY,
    SolveLoop,
    release_kept_loops,
    solve_single_level,
)
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, resample, step2d
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d
from levelsetfusion_tpu_torch.utils import profiling
from levelsetfusion_tpu_torch.utils.config import PRESETS
from tests.torch_ranks import run_ranks


def _profiled(fn, tmp_path):
    """``fn()``'s result and the ``lsf.`` spans the profiler recorded while
    it ran, by name; ``spans()`` counts the same calls."""
    with profiling.trace(str(tmp_path)) as prof:
        out = fn()
    spans = _spans(prof)
    assert {n: s["calls"] for n, s in profiling.spans().items()} == spans
    return out, spans


def _spans(prof):
    """A stopped profiler's ``lsf.`` spans, by name."""
    names = (e.name() for e in prof.profiler.kineto_results.events())
    return collections.Counter(n for n in names if n.startswith("lsf."))


def _pair(shape=(10, 8, 6), seed=0):
    base = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(np.tanh(base * 0.3)),
            torch.from_numpy(np.tanh(np.roll(base, 1, 0) * 0.3)))


def test_span_without_a_profiler_is_one_check(monkeypatch):
    calls = []
    real = torch._C._autograd._profiler_enabled

    def enabled():
        calls.append(1)
        return real()

    def refused(name):
        raise AssertionError("a profiler range made with no profiler running")

    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", enabled)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    before = profiling.counters(), profiling.spans()
    ctx = profiling.span("lsf.test")
    assert calls == [1]
    assert ctx is profiling.span("lsf.other")
    with ctx:
        pass
    profiling.count("test.count", 5)
    assert (profiling.counters(), profiling.spans()) == before


def test_count_and_spans_only_under_a_profiler(tmp_path):
    profiling.count("test.count", 3)
    with profiling.span("lsf.test"):
        pass
    assert "test.count" not in profiling.counters() and "lsf.test" not in profiling.spans()
    with profiling.trace(str(tmp_path)):
        profiling.count("test.count", 3)
        profiling.count("test.count")
        for _ in range(3):
            with profiling.span("lsf.test"):
                pass
    assert profiling.counters()["test.count"] == 4
    assert profiling.spans()["lsf.test"]["calls"] == 3
    assert 0 < profiling.spans()["lsf.test"]["host_s"] < 1
    with profiling.trace(str(tmp_path)):  # a trace starts from zero
        assert profiling.counters() == {} and profiling.spans() == {}


@pytest.mark.parametrize("iterations,threshold", [(40, 0.0), (16, 0.0), (60, 2e-2)])
def test_solve_spans(iterations, threshold, tmp_path):
    """solve_single_level (its loop eager on the CPU): one look-up of the
    kept loop, which builds it on a miss and nothing on a hit, the solve,
    one flag read before the first chunk and one after each and the result
    read; a call of other params misses again, and so does one of the first
    params after it. A SolveLoop called directly records no look-up;
    ``release_kept_loops`` records the release."""
    c, l = _pair()
    params = SolverParams(max_iterations=iterations, learning_rate=0.3,
                          convergence_threshold=threshold)
    release_kept_loops()

    def profiled(fn):
        out, spans = _profiled(fn, tmp_path)
        return out, spans, profiling.counters()

    res, spans, counts = profiled(lambda: solve_single_level(c, l, params))
    chunks = math.ceil(res.iterations / CHECK_EVERY)
    assert threshold > 0 or res.iterations == iterations
    solve = {"lsf.solve": 1, "lsf.solve.flag_read": chunks + 1, "lsf.solve.result_read": 1}
    assert (spans, counts) == ({"lsf.solve.build": 1, **solve}, {"solve.loop_built": 1})
    again, spans, counts = profiled(lambda: solve_single_level(c, l, params))
    assert again.iterations == res.iterations and torch.equal(again.warp, res.warp)
    assert (spans, counts) == ({"lsf.solve.build": 1, **solve}, {"solve.loop_kept": 1})
    other = params.replace(learning_rate=0.2)
    _, spans, counts = profiled(lambda: solve_single_level(c, l, other))
    assert spans["lsf.solve.build"] == 1 and "lsf.solve.release" not in spans
    assert counts == {"solve.loop_built": 1}
    _, spans, counts = profiled(lambda: solve_single_level(c, l, params))
    assert (spans, counts) == ({"lsf.solve.build": 1, **solve}, {"solve.loop_built": 1})
    loop = SolveLoop(c.shape, params, c.device, graph=False)
    again, spans, counts = profiled(lambda: loop.solve(c, l))
    assert again.iterations == res.iterations and torch.equal(again.warp, res.warp)
    assert (spans, counts) == (solve, {})
    _, spans, counts = profiled(release_kept_loops)
    assert (spans, counts) == ({"lsf.solve.release": 1}, {})


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_loop(check_every):
    """The state ``SolveLoop._replay`` reads, with a graph that only counts
    its replays."""
    return types.SimpleNamespace(_graph=_StubGraph(), graph_launches={}, chunk_kernels=107,
                                 check_every=check_every, replays=0)


@pytest.mark.parametrize("check_every,replays", [(16, 3), (2, 1)])
def test_replay_counts_kernels_and_iterations_under_a_profiler(check_every, replays,
                                                               tmp_path):
    """Each replay adds the chunk's kernel nodes to ``solve.graph_kernels``
    and its iterations to ``solve.graph_iterations`` while a profiler runs,
    and nothing without one."""
    loop = _stub_loop(check_every)
    before = profiling.counters()
    SolveLoop._replay(loop)
    assert profiling.counters() == before and loop._graph.replays == loop.replays == 1
    with profiling.trace(str(tmp_path)):
        for _ in range(replays):
            SolveLoop._replay(loop)
        counts = profiling.counters()
    assert counts == {"solve.graph_kernels": 107 * replays,
                      "solve.graph_iterations": check_every * replays}
    assert loop._graph.replays == loop.replays == 1 + replays


@pytest.mark.parametrize("dim", [2, 3])
def test_replay_counts_the_2d_step_where_the_chunk_launched_it(dim, tmp_path):
    """A replay adds the 2D step's launches of its chunk to
    ``solve.step2d_iterations`` under a profiler, and to the step's
    ``launch_count`` always; a chunk that launched none (a 3D loop's) adds
    no such counter."""
    loop = _stub_loop(16)
    loop.graph_launches = ({step2d: 16, resample: 0, fused_gradient: 0} if dim == 2
                           else {step2d: 0, resample: 16, fused_gradient: 16})
    launched, before = step2d.launch_count, profiling.counters()
    SolveLoop._replay(loop)
    assert profiling.counters() == before
    with profiling.trace(str(tmp_path)):
        SolveLoop._replay(loop)
        SolveLoop._replay(loop)
        counts = profiling.counters()
    want = {"solve.graph_kernels": 107 * 2, "solve.graph_iterations": 32}
    if dim == 2:
        want["solve.step2d_iterations"] = 32
    assert counts == want
    assert step2d.launch_count == launched + (48 if dim == 2 else 0)


def test_tsdf_2d_span(tmp_path):
    """A 2D TSDF under the profiler adds one ``lsf.tsdf`` call, as a 3D one
    does."""
    pair = synthetic.bump_wall_pair_2d(width=32)
    grid = GridSpec(shape=(12, 8), voxel_size=0.004, offset=(-6, 96))
    _, spans = _profiled(lambda: generate_tsdf_2d(torch.from_numpy(pair.live_depth),
                                                  pair.camera, grid), tmp_path)
    assert spans == {"lsf.tsdf": 1}


def _intervals(prof, name):
    """(start, end) ns of a stopped profiler's host events ``name``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == name:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out)


@pytest.mark.parametrize("pyramid_method", ["ewa_depth", "block_mean"])
def test_hierarchical_pyramid_and_prolongate_spans(pyramid_method, tmp_path):
    """A 2-level hierarchical 2D solve under the profiler: one ``lsf.pyramid``
    a field, holding that pyramid's ``lsf.tsdf`` calls (one a level, from
    depth), one ``lsf.prolongate`` a hand-off between levels; with no
    profiler the solve records nothing."""
    pair = synthetic.bump_wall_pair_2d(width=32, wall_depth=0.08, bump_height=0.008,
                                       bump_radius_px=5.0, live_shift_px=2.0)
    grid = GridSpec(shape=(16, 8), voxel_size=0.004, offset=(-8, 16))
    hp = HierarchicalParams(levels=2, base=SolverParams(max_iterations=5, learning_rate=1.0,
                                                        sobolev_smoothing=True))
    rows = [torch.from_numpy(d) for d in (pair.canonical_depth, pair.live_depth)]

    def solve():
        if pyramid_method == "ewa_depth":
            return hierarchical.solve_hierarchical_from_depth(*rows, pair.camera, grid, hp,
                                                              narrow_band_width_voxels=8)
        fields = [generate_tsdf_2d(r, pair.camera, grid, narrow_band_width_voxels=8)
                  for r in rows]
        return hierarchical.solve_hierarchical(*fields, hp)

    release_kept_loops()
    before = profiling.spans()
    solve()
    assert profiling.spans() == before  # no profiler: nothing recorded
    with profiling.trace(str(tmp_path)) as prof:
        solve()
    spans = _spans(prof)
    tsdfs = 2 * hp.levels if pyramid_method == "ewa_depth" else 2
    assert spans["lsf.pyramid"] == 2 and spans["lsf.prolongate"] == hp.levels - 1
    assert spans["lsf.tsdf"] == tsdfs and spans["lsf.solve"] == hp.levels
    pyramids, inside = _intervals(prof, "lsf.pyramid"), collections.Counter()
    for start, end in _intervals(prof, "lsf.tsdf"):
        held = [i for i, (a, b) in enumerate(pyramids) if a <= start and end <= b]
        inside[tuple(held)] += 1
    if pyramid_method == "ewa_depth":
        assert inside == {(0,): hp.levels, (1,): hp.levels}
    else:  # the finest TSDFs are made before the block-mean pyramids
        assert inside == {(): 2}
    for start, end in _intervals(prof, "lsf.prolongate"):
        assert not any(a <= start < b for a, b in pyramids + _intervals(prof, "lsf.solve"))


SEQ = dict(num_frames=4, width=48, height=48, blob_radius_px=10.0, blob_height=0.05,
           drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1)


def _fusion_config():
    return fusion.FusionPipelineConfig(
        grid=GridSpec(shape=(24, 24, 16), voxel_size=0.008, offset=(-12, -12, 46)),
        hierarchical=False,
        solver=SolverParams(smoothing_mode=SmoothingMode.KILLING, max_iterations=18,
                            learning_rate=0.5, smoothing_term_weight=0.1,
                            convergence_threshold=0.0))


@pytest.mark.parametrize("pipelined", [True, False])
def test_fusion_frame_spans(pipelined, tmp_path):
    """fuse_sequence over 4 frames: a TSDF and a frame read each (and the
    read that finds the end), and for frames 1-3 a loop look-up, a solve, a
    blend and a report read; the first look-up builds the loop, the others
    reuse it."""
    seq = synthetic.snoopy_style_sequence_3d(**SEQ)
    cfg = _fusion_config()
    release_kept_loops()
    res, spans = _profiled(lambda: fusion.fuse_sequence(
        seq.frames, seq.camera, cfg, device="cpu", pipelined=pipelined), tmp_path)
    n = len(seq.frames)
    assert len(res.reports) == n - 1
    assert profiling.counters() == {"solve.loop_built": 1, "solve.loop_kept": n - 2}
    reads = sum(math.ceil(r.solver_iterations / CHECK_EVERY) + 1 for r in res.reports)
    assert spans == {"lsf.frame.next": n + 1, "lsf.tsdf": n, "lsf.solve.build": n - 1,
                     "lsf.solve": n - 1, "lsf.solve.flag_read": reads,
                     "lsf.solve.result_read": n - 1, "lsf.frame.blend": n - 1,
                     "lsf.frame.report_read": n - 1}


def test_prefetch_wait_once_a_frame(tmp_path):
    if not native_loader.native_available():
        pytest.skip("the native depth loader needs a C++ compiler")
    frames = synthetic.snoopy_style_sequence_3d(**SEQ).frames
    paths = []
    for t, frame in enumerate(frames):
        paths.append(str(tmp_path / f"depth_{t:06d}.png"))
        depth.save_depth_png(paths[-1], np.asarray(frame))
    pf = native_loader.DepthPrefetcher(paths, width=48, height=48)
    got, spans = _profiled(lambda: list(pf), tmp_path)
    assert len(got) == len(paths)
    assert spans == {"lsf.io.prefetch_wait": len(paths)}


HALO_CASES = [((6, 5, 4), 2, 0, True), ((6, 5, 4), 8, 0, False), ((4, 7, 3), 3, 1, True)]


@pytest.fixture(scope="module")
def halo_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo_bytes")
    return run_ranks("tests.torch_ranks.halo_bytes_cases", 2, tmp,
                     {"cases": HALO_CASES, "log_dir": str(tmp / "traces")})


@pytest.mark.parametrize("case", range(len(HALO_CASES)))
def test_halo_bytes_sent(halo_ranks, case):
    """On 2 gloo ranks each rank has one neighbour: the count equals the
    bytes handed to isend, width slices of the block (both blocks' when the
    halo is wider than one), with one exchange, one wait and one reduction
    span."""
    shape, width, axis, _ = HALO_CASES[case]
    plane = np.prod(shape) // shape[axis] * 4
    for counted, handed, spans in (rank[case] for rank in halo_ranks):
        assert counted == handed == min(width, shape[axis]) * plane
        assert spans == {"lsf.halo.exchange": 1, "lsf.halo.wait": 1, "lsf.reduce": 1}


def test_cli_profile_writes_counters(tmp_path):
    cfg = PRESETS["config1_2d_pair"]
    cfg = dataclasses.replace(cfg, solver=cfg.solver.replace(max_iterations=25))
    path = tmp_path / "c1.json"
    path.write_text(cfg.to_json())
    release_kept_loops()
    for run, want in (("run", "solve.loop_built"), ("again", "solve.loop_kept")):
        out = tmp_path / run  # the second run reuses the first one's kept loop
        assert cli.main(["--config", str(path), "--out", str(out), "--device", "cpu",
                         "--profile"]) == 0
        with open(out / "summary.json") as f:  # one device: no halo exchange
            assert json.load(f)["counters"] == {want: 1}
        with open(os.path.join(out, "trace", "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"lsf.solve.build", "lsf.solve", "lsf.solve.flag_read",
                "lsf.solve.result_read"} <= names
