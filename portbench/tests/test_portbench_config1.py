"""config1-pairs, the 2D scanline solve: its traffic (the same pool for
every seed), its entry path and plain 2D reference on the CPU at a small
size, the faults that must make it not correct, the readers of its new
metrics (``kernels_per_iter``, ``step2d_roofline``), the run's writes, and
on the card the cell end to end, its faults and the kernel count against a
profiled replay."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import levelsetfusion_tpu_torch.models.single_level as program_loop
from portbench.drivers import pair_solve_2d
from portbench.lib import cells, faults, harness, peaks, program, tracing
from portbench.lib import traffic as gen
from portbench.lib.tracing import TRACED, Event, reduce_events
from portbench.reference import solver2d, tsdf2d
import test_portbench_hygiene as hygiene
from tiny import cell, run

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "config1-pairs"
MS = 1_000_000  # ns
# A grid and a bump small enough for the CPU: the bump (radius 6 px, 12 mm
# high at 40 cm) lies inside the 24 x 16 voxels, and every pair converges.
SMALL = dict(bump_radius_px=6.0, bump_height=0.012, shift_px=[0.5, 2.0])


def small(workload=WORKLOAD, iterations=600):
    c = cell(workload, iterations, grid_shape=[24, 16], grid_offset=[-12, 92])
    return c._replace(traffic={**c.traffic, **SMALL})


def _mix():
    with open(cells.HERE / "traffic" / "bump_pairs32.json") as f:
        return json.load(f)


# --- traffic -------------------------------------------------------------


def test_every_seed_the_same_pool_in_its_own_order():
    mix = _mix()

    def work(seed):
        return [(p.shift_px, p.height_scale) for p in gen.generate(mix, seed)]

    assert sorted(work(1)) == sorted(work(2**33 + 5)) and work(1) != work(2**33 + 5)
    shifts = sorted(abs(s) for s, _ in work(1))
    assert shifts[0] == mix["shift_px"][0] and shifts[-1] == mix["shift_px"][1]
    assert sum(s < 0 for s, _ in work(1)) == mix["pool"] // 2  # half move each way
    assert len(set(work(1))) == mix["pool"]
    a, b = gen.generate(mix, 2**31 + 17), gen.generate(mix, 2**31 + 17)
    assert all(np.array_equal(x.live, y.live) and np.array_equal(x.canonical, y.canonical)
               for x, y in zip(a, b))
    assert a[0].live.shape == (mix["camera"]["width"],) and a[0].live.dtype == np.float32


def test_bump_row_is_the_programs():
    from levelsetfusion_tpu_torch.io import synthetic

    bump = gen.generator("bump_pairs").bump_row
    pair = synthetic.bump_wall_pair_2d(width=128, bump_height=0.04, bump_radius_px=20.0,
                                       live_shift_px=-5.0, live_height_scale=1.1)
    assert np.array_equal(bump(128, 0.4, 64.0, 20.0, 0.04), pair.canonical_depth)
    assert np.array_equal(bump(128, 0.4, 59.0, 20.0, 0.04 * 1.1), pair.live_depth)


# --- the entry path and the reference ------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_cpu(trace):
    c = small()
    line = run(c, trace=trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"tsdf_gap", "warp_gap", "warped_gap", "iterations_gap"}
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names and line["metrics"]


def test_record_counts_the_2d_step_in_b2s_place(tmp_path):
    c = small(iterations=20)
    r = harness.Run(c, 5, 0.2, torch.device("cpu"), tracing.Tracer(False), str(tmp_path))
    state = pair_solve_2d.setup(r)
    record = pair_solve_2d.window(r, state)
    v = 24 * 16
    assert (record.voxels, record.dim) == (v, 2)
    assert record.b1_call_bytes == peaks.b1_bytes(v, 2) == 4 * v * 4
    assert record.b2_call_bytes == peaks.b2_bytes(v, 2) == 6 * v * 4


def test_reference_tsdf_matches_the_definition():
    cam = pair_solve_2d.ScanCamera(8.0, 8.0, 16)
    depth = torch.full((16,), 0.4)
    depth[0] = 0.0
    out = tsdf2d.generate(depth, cam, (4, 6), 0.01, (-2, 37), 4)
    # Column x = 2: world x 0, pixel 8, depth 0.4 m; z = (37 + k) cm.
    z = (torch.arange(6, dtype=torch.float32) + 37) * 0.01
    assert torch.allclose(out[2], torch.clamp((0.4 - z) / 0.02, -1, 1))
    far = tsdf2d.generate(depth, cam, (4, 6), 0.1, (-2, 1), 4)  # x = -0.2 m: u < 0 at z 0.1
    assert far[0, 0] == 1.0
    assert pair_solve_2d.scan_camera({"width": 128}) == (64.0, 64.0, 128)


def test_reference_resample_is_bilinear_with_unit_fill():
    field = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    warp = torch.zeros(2, 3, 4)
    assert torch.equal(solver2d.resample(field, warp), field)
    warp[1] += 0.5  # halfway to the next z column; the last column meets the +1 fill
    out = solver2d.resample(field, warp)
    assert torch.allclose(out[:, :3], 0.5 * (field[:, :3] + field[:, 1:]))
    assert torch.allclose(out[:, 3], 0.5 * (field[:, 3] + 1.0))


def test_reference_solve_stops_by_its_rules():
    rng = np.random.default_rng(0)
    canonical = torch.tensor(np.tanh(rng.standard_normal((10, 8)) * 0.4), dtype=torch.float32)
    live = torch.roll(canonical, 1, 0)
    p = solver2d.Params(1.0, 7, 1e-3, 1.0, 0.2)
    sol = solver2d.solve(canonical, live, p)
    assert sol.iterations == 7 and sol.energies.shape == (7, 2)
    assert solver2d.solve(canonical, canonical, p).iterations == 1  # nothing to move
    # The Tikhonov term alone: -Δu with replicated edges.
    u = torch.zeros(2, 4, 3)
    u[0, 1, 1] = 1.0
    lap = solver2d.laplacian(u[0])
    assert lap[1, 1] == -4.0 and lap[0, 1] == lap[2, 1] == lap[1, 0] == lap[1, 2] == 1.0
    assert lap.sum() == 0.0


# --- faults --------------------------------------------------------------


def _frozen_2d_step(real):
    """The 2D step returning its state unchanged: a zero gradient."""
    def frozen(canonical, warped, warp, **kw):
        res = real(canonical, warped, warp, **kw)
        return res._replace(gradient=torch.zeros_like(res.gradient))
    return frozen


def test_state_unchanged(monkeypatch):
    program_loop.release_kept_loops()
    monkeypatch.setattr(program_loop, "energy_gradient",
                        _frozen_2d_step(program_loop.energy_gradient))
    assert not run(small())["correct"]


def test_answer_altered(monkeypatch):
    monkeypatch.setattr(pair_solve_2d, "warp_field_cm",
                        faults.shifted(pair_solve_2d.warp_field_cm, 0.1))
    assert not run(small())["correct"]


# --- the new readers -----------------------------------------------------


def _readings(trace=True):
    v = 96 * 48
    record = harness.Record(
        latencies_s=[0.1, 0.2, 0.3, 0.4], attempted=4, failed=0, window_s=1.0,
        iterations=[400, 450, 500, 300], voxels=v, dim=2,
        b1_call_bytes=peaks.b1_bytes(v, 2), b2_call_bytes=peaks.b2_bytes(v, 2))
    events = [Event(False, TRACED, 0, 10 * MS),
              Event(True, "void warp_field_cm_kernel<unsigned int>(A)", 0, 2 * MS),
              Event(True, "void at::native::elementwise_kernel<128, 2>(A)", 2 * MS, 7 * MS),
              Event(True, "Memcpy DtoD", 7 * MS, 8 * MS)]
    # Requests 1 and 2 ran inside the stretch.
    return harness.Readings(record, reduce_events(events, 1, 3, 0.01) if trace else None, 1)


def _read(name, readings):
    return cells.reader(name).read(readings)


COUNTS = {"solve.graph_kernels": 107 * 60, "solve.graph_iterations": 16 * 60,
          "solve.loop_kept": 2}


def test_kernels_per_iteration(monkeypatch):
    monkeypatch.setattr(program, "counters", lambda: COUNTS)
    assert _read("kernels_per_iter.solves", _readings()) == pytest.approx(107 / 16)


def test_step2d_roofline():
    # 950 iterations of the 2D step's bytes over the 6 ms of kernels but B1's.
    want = 100 * 950 * peaks.b2_bytes(96 * 48, 2) / peaks.HBM_BYTES_PER_S / 0.006
    assert _read("step2d_roofline.solves", _readings()) == pytest.approx(want)


@pytest.mark.parametrize("counts,trace", [
    (COUNTS, False),
    ({"solve.loop_kept": 2}, True),
    ({"solve.graph_kernels": 0, "solve.graph_iterations": 0}, True),
])
def test_kernels_per_iteration_reads_nothing(monkeypatch, counts, trace):
    monkeypatch.setattr(program, "counters", lambda: counts)
    assert _read("kernels_per_iter.solves", _readings(trace)) is None


def test_kernels_per_iteration_from_a_program_that_counts_none(monkeypatch):
    from levelsetfusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read("kernels_per_iter.solves", _readings()) is None


def test_step2d_roofline_reads_nothing():
    assert _read("step2d_roofline.solves", _readings(trace=False)) is None
    only_b1 = _readings()
    only_b1.trace = only_b1.trace._replace(kernel_s={"warp_field_cm_kernel<unsigned int>": 1.0})
    assert _read("step2d_roofline.solves", only_b1) is None


# --- the run's writes ----------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_run_writes_only_where_allowed(trace, tmp_path, monkeypatch):
    monkeypatch.setattr(hygiene, "cell", small)
    hygiene.test_run_writes_only_where_allowed(WORKLOAD, trace, tmp_path, monkeypatch)


# --- on the card ---------------------------------------------------------


@pytest.mark.card
def test_cell_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOAD, "--seed", "4294967311",
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("fault", ["state", "answer"])
def test_faults_on_the_card(card, fault, monkeypatch):
    """The cell at its size on the card, with the 2D step frozen or the
    answer altered where it is made: not correct."""
    program_loop.release_kept_loops()  # a kept loop's graph holds the sound step
    if fault == "state":
        monkeypatch.setattr(program_loop, "energy_gradient",
                            _frozen_2d_step(program_loop.energy_gradient))
    else:
        monkeypatch.setattr(pair_solve_2d, "warp_field_cm",
                            faults.shifted(pair_solve_2d.warp_field_cm, 0.1))
    args = harness.parse(["--workload", WORKLOAD, "--seed", "4294967357", "--seconds", "3"])
    res = harness.run_rank(cells.cell(WORKLOAD), args, 0, 1, 0.0)
    line = harness.result_line(cells.cell(WORKLOAD), [res], False)
    program_loop.release_kept_loops()
    print(fault, line["checks"])
    assert not line["correct"], line["checks"]


@pytest.mark.card
def test_kept_loop_counts_its_chunks(card, tmp_path):
    """``test_portbench_loop_reuse.py``'s card case with the counters the
    replays add besides the kept loop's: a second solve of one key, from
    another stream, replays the kept graph and gives the first one's answer;
    every replay adds the chunk's kernel nodes and iterations, which
    ``kernels_per_iter.solves`` reads."""
    from levelsetfusion_tpu_torch.models.params import SolverParams
    from levelsetfusion_tpu_torch.models.single_level import _kept_loops
    from levelsetfusion_tpu_torch.utils import profiling

    gen_ = torch.Generator().manual_seed(7)
    canonical, live = (torch.tanh(torch.randn(32, 32, 24, generator=gen_)).cuda()
                       for _ in range(2))
    params = SolverParams(max_iterations=40, learning_rate=0.3, convergence_threshold=0.0)
    program_loop.release_kept_loops()
    with profiling.trace(str(tmp_path)):
        first = program_loop.solve_single_level(canonical, live, params)
        with torch.cuda.stream(torch.cuda.Stream()):  # the kept loop waits for the first
            again = program_loop.solve_single_level(canonical, live, params)
            torch.cuda.current_stream().synchronize()
    loop = _kept_loops()[canonical.device][0]
    assert loop.replays == 2 * 3  # 40 iterations: three chunks of 16 a solve
    assert program.counters() == {
        "solve.loop_built": 1, "solve.loop_kept": 1,
        "solve.graph_kernels": loop.chunk_kernels * loop.replays,
        "solve.graph_iterations": 16 * loop.replays}
    assert _read("kernels_per_iter.solves", _readings()) == loop.chunk_kernels / 16
    assert _read("loop_reuse_pct.solves", _readings()) == pytest.approx(50.0)
    assert torch.equal(first.warp, again.warp) and first.iterations == again.iterations
    program_loop.release_kept_loops()


@pytest.mark.card
@pytest.mark.parametrize("shape", [(96, 48), (64, 48, 40)])
def test_chunk_kernels_match_a_profiled_replay(card, shape):
    """The kernel nodes counted at capture equal the device kernels of one
    profiled replay of the chunk."""
    from torch.profiler import ProfilerActivity, profile

    from levelsetfusion_tpu_torch.models.single_level import SolveLoop
    from levelsetfusion_tpu_torch.utils.config import PRESETS

    name = "config1_2d_pair" if len(shape) == 2 else "config3_3d_full_energy"
    params = PRESETS[name].solver.replace(max_iterations=32, convergence_threshold=0.0)
    gen_ = torch.Generator().manual_seed(3)
    canonical, live = (torch.tanh(torch.randn(*shape, generator=gen_)).cuda() for _ in range(2))
    loop = SolveLoop(shape, params, canonical.device)
    loop.solve(canonical, live)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop._replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    print(shape, loop.chunk_kernels, len(kernels), len(names))
    assert loop.chunk_kernels == len(kernels)
