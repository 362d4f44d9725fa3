"""config2-hier, the coarse-to-fine 2D scanline solve: its traffic (the same
pool for every seed), its entry path and plain hierarchical reference on the
CPU at config2's size, the faults that must make it not correct (the 2D
step frozen at one level, the warm start dropped, the answer altered), the
readers of its new metrics (``pyramid_ms``, ``levels_roofline``), the run's
writes, and on the card the cell end to end, traced, and its faults."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import levelsetfusion_tpu_torch.models.single_level as program_loop
from levelsetfusion_tpu_torch.ops import pyramid
from levelsetfusion_tpu_torch.ops.kernels import step2d
from portbench.drivers import pair_solve_hier2d
from portbench.lib import cells, faults, harness, peaks, program, tracing
from portbench.lib import traffic as gen
from portbench.lib.tracing import TRACED, Event, reduce_events
import test_portbench_hygiene as hygiene
from tiny import run

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "config2-hier"
MS = 1_000_000  # ns
HIER = ("iters_per_solve.hier", "pair_solve_p95_ms.hier", "device_idle_pct.hier",
        "host_reads.hier", "loop_reuse_pct.hier", "kernels_per_iter.hier", "pyramid_ms.hier",
        "levels_roofline.hier")


def cell(workload=WORKLOAD, iterations=60):
    """The cell at its size (it runs on the CPU in seconds), each level's
    iterations capped at ``iterations``."""
    c = cells.cell(workload)
    cfg = dict(c.config)
    cfg["solver"] = dict(cfg["solver"], max_iterations=iterations)
    return c._replace(config=cfg)


def _mix():
    with open(cells.HERE / "traffic" / "bump_pairs32_wide.json") as f:
        return json.load(f)


# --- traffic -------------------------------------------------------------


def test_every_seed_the_same_pool_in_its_own_order():
    mix = _mix()

    def work(seed):
        return [(p.shift_px, p.height_scale) for p in gen.generate(mix, seed)]

    assert sorted(work(3)) == sorted(work(2**33 + 7)) and work(3) != work(2**33 + 7)
    shifts = sorted(abs(s) for s, _ in work(3))
    assert (shifts[0], shifts[-1]) == (4.0, 12.0) == tuple(mix["shift_px"])
    assert sum(s < 0 for s, _ in work(3)) == mix["pool"] // 2  # half move each way
    assert len(set(work(3))) == mix["pool"] == 32
    a, b = gen.generate(mix, 2**31 + 19), gen.generate(mix, 2**31 + 19)
    assert all(np.array_equal(x.live, y.live) and np.array_equal(x.canonical, y.canonical)
               for x, y in zip(a, b))
    assert a[0].live.shape == (128,) and a[0].live.dtype == np.float32
    order = gen.rounds(mix, 5, 32)
    assert sorted(order(i) for i in range(32, 64)) == list(range(32))  # each round whole


# --- the entry path and the reference ------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_cpu(trace):
    c = cell()
    line = run(c, trace=trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"tsdf_gap", "warp_gap", "warped_gap", "iterations_gap"}
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names and line["metrics"]
    if trace:
        assert set(HIER) == names


def test_record_counts_each_level(tmp_path):
    c = cell(iterations=20)
    r = harness.Run(c, 5, 0.2, torch.device("cpu"), tracing.Tracer(False), str(tmp_path))
    state = pair_solve_hier2d.setup(r)
    record = pair_solve_hier2d.window(r, state)
    assert (record.voxels, record.dim) == (96 * 64, 2)
    assert record.level_voxels == [24 * 16, 48 * 32, 96 * 64]
    assert record.b2_call_bytes == peaks.b2_bytes(96 * 64, 2)
    assert len(record.level_iterations) == len(record.iterations) == record.attempted
    assert all(len(its) == 3 and sum(its) == total and max(its) <= 20
               for its, total in zip(record.level_iterations, record.iterations))


def test_compare_reads_every_field_and_the_widest_level():
    z = torch.zeros(4, 4)
    got = pair_solve_hier2d.Answer([z, z], [z, z], z, torch.zeros(2, 4, 4), z, [60, 60])
    moved = z.clone()
    moved[1, 2] = 0.25
    want = got._replace(live=[z, moved], iterations=[60, 57])
    row = pair_solve_hier2d.compare(got, want)
    assert row == {"tsdf_gap": 0.25, "warp_gap": 0.0, "warped_gap": 0.0, "iterations_gap": 3.0}
    assert pair_solve_hier2d.compare(got, got._replace(field=moved))["tsdf_gap"] == 0.25


# --- faults --------------------------------------------------------------


def _frozen_at(shape, real):
    """The 2D step returning its state unchanged at a level of ``shape``."""
    def frozen(live, canonical, warp_cm, rate, **kw):
        new, stats = real(live, canonical, warp_cm, rate, **kw)
        if tuple(live.shape) == shape:
            new.copy_(warp_cm)
        return new, stats
    return frozen


def _plant(fault, monkeypatch):
    if fault == "frozen_level":
        monkeypatch.setattr(step2d, "step2d", _frozen_at((96, 64), step2d.step2d))
    elif fault == "no_warm_start":
        monkeypatch.setattr(pyramid, "prolongate_warp",
                            lambda warp, target_shape=None: torch.zeros(
                                (*target_shape, warp.shape[-1]), dtype=warp.dtype,
                                device=warp.device))
    else:
        monkeypatch.setattr(pair_solve_hier2d, "warp_field_cm",
                            faults.shifted(pair_solve_hier2d.warp_field_cm, 0.1))


FAULTS = ("frozen_level", "no_warm_start", "answer")


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    program_loop.release_kept_loops()
    _plant(fault, monkeypatch)
    line = run(cell())
    program_loop.release_kept_loops()
    assert not line["correct"], line["checks"]


# --- the new readers -----------------------------------------------------


def _readings(trace=True, levels=True):
    record = pair_solve_hier2d.HierRecord(
        latencies_s=[0.004, 0.005, 0.006, 0.007], attempted=4, failed=0, window_s=1.0,
        iterations=[150, 180, 170, 160], voxels=96 * 64, dim=2,
        b1_call_bytes=peaks.b1_bytes(96 * 64, 2), b2_call_bytes=peaks.b2_bytes(96 * 64, 2),
        level_iterations=[[60, 60, 30], [60, 60, 60], [60, 60, 50], [60, 60, 40]] if levels
        else [], level_voxels=[24 * 16, 48 * 32, 96 * 64] if levels else [])
    events = [Event(False, TRACED, 0, 10 * MS),
              Event(True, "void warp_field_cm_kernel<unsigned int>(A)", 0, 1 * MS),
              Event(True, "step2d_kernel", 1 * MS, 4 * MS),
              Event(True, "void at::native::elementwise_kernel<128, 2>(A)", 4 * MS, 5 * MS)]
    # Requests 1 and 2 ran inside the stretch.
    return harness.Readings(record, reduce_events(events, 1, 3, 0.01) if trace else None, 1)


def _read(name, readings):
    return cells.reader(name).read(readings)


def test_levels_roofline():
    # Requests 1 and 2: each level's iterations at its own size, over the
    # 4 ms of kernels but B1's.
    moved = sum(its * peaks.b2_bytes(v, 2) for its, v in
                zip([120, 120, 110], [24 * 16, 48 * 32, 96 * 64]))
    want = 100 * moved / peaks.HBM_BYTES_PER_S / 0.004
    assert _read("levels_roofline.hier", _readings()) == pytest.approx(want)
    # One size for every call (``step2d_roofline``'s) would count 350 finest calls.
    one_size = 100 * 350 * peaks.b2_bytes(96 * 64, 2) / peaks.HBM_BYTES_PER_S / 0.004
    assert one_size > 1.4 * want


def test_levels_roofline_reads_nothing():
    assert _read("levels_roofline.hier", _readings(trace=False)) is None
    assert _read("levels_roofline.hier", _readings(levels=False)) is None
    plain = _readings()
    plain.record = harness.Record(**{f: getattr(plain.record, f) for f in (
        "latencies_s", "attempted", "failed", "window_s", "iterations", "voxels", "dim",
        "b1_call_bytes", "b2_call_bytes")})
    assert _read("levels_roofline.hier", plain) is None
    only_b1 = _readings()
    only_b1.trace = only_b1.trace._replace(kernel_s={"warp_field_cm_kernel<unsigned int>": 1.0})
    assert _read("levels_roofline.hier", only_b1) is None


SPANS = {"lsf.pyramid": {"calls": 4, "host_s": 0.006}, "lsf.tsdf": {"calls": 12, "host_s": 0.005},
         "lsf.solve.flag_read": {"calls": 36, "host_s": 0.002},
         "lsf.solve.result_read": {"calls": 6, "host_s": 0.001}}


def test_pyramid_ms(monkeypatch):
    monkeypatch.setattr(program, "spans", lambda: SPANS)
    assert _read("pyramid_ms.hier", _readings()) == pytest.approx(3.0)  # 6 ms over 2 pairs
    assert _read("host_reads.hier", _readings()) == pytest.approx(21.0)  # (36 + 6) / 2


@pytest.mark.parametrize("spans,trace", [
    (SPANS, False),
    ({"lsf.tsdf": {"calls": 12, "host_s": 0.005}}, True),
    ({}, True),
])
def test_pyramid_ms_reads_nothing(monkeypatch, spans, trace):
    monkeypatch.setattr(program, "spans", lambda: spans)
    assert _read("pyramid_ms.hier", _readings(trace)) is None


def test_pyramid_ms_from_a_program_that_records_none(monkeypatch):
    from levelsetfusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _read("pyramid_ms.hier", _readings()) is None


def test_reported_in_config2_hier_only():
    for w in cells.benchmark()["workloads"]:
        metrics = {m["name"] for m in cells.cell(w["name"]).per_layer}
        assert set(HIER) & metrics == (set(HIER) if w["name"] == WORKLOAD else set())


# --- the run's writes ----------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_run_writes_only_where_allowed(trace, tmp_path, monkeypatch):
    monkeypatch.setattr(hygiene, "cell", lambda workload: cell(workload, iterations=20))
    hygiene.test_run_writes_only_where_allowed(WORKLOAD, trace, tmp_path, monkeypatch)


# --- on the card ---------------------------------------------------------


def _run_on_the_card(seed, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOAD, "--seed", str(seed),
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
def test_cell_on_the_card(card):
    line = _run_on_the_card(4294967311, 0)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"pair_solves_per_s", "setup_s"}


@pytest.mark.card
def test_traced_cell_reports_every_hier_metric(card):
    line = _run_on_the_card(4294967357, 1)
    assert line["correct"], line["checks"]
    metrics = {name: m["value"] for name, m in line["metrics"].items()}
    print(metrics)
    assert set(metrics) == set(HIER)
    assert metrics["loop_reuse_pct.hier"] == 100.0
    assert metrics["kernels_per_iter.hier"] == 2.0
    assert 0 < metrics["levels_roofline.hier"] <= 100
    assert metrics["pyramid_ms.hier"] > 0


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_on_the_card(card, fault, monkeypatch):
    """The cell at its size on the card with each fault planted: not
    correct."""
    program_loop.release_kept_loops()  # a kept loop's graph holds the sound step
    _plant(fault, monkeypatch)
    args = harness.parse(["--workload", WORKLOAD, "--seed", "4294967371", "--seconds", "3"])
    res = harness.run_rank(cells.cell(WORKLOAD), args, 0, 1, 0.0)
    line = harness.result_line(cells.cell(WORKLOAD), [res], False)
    program_loop.release_kept_loops()
    print(fault, line["checks"])
    assert not line["correct"], line["checks"]
