"""The per-layer and end-to-end metric readers and the trace reduction, on
canned records and profiler events."""

import pytest

from portbench.lib import cells, harness, peaks
from portbench.lib.tracing import TRACED, Event, busy_union, reduce_events, short_name

MS = 1_000_000  # ns


def _record(**kw):
    base = dict(latencies_s=[0.1, 0.2, 0.3, 0.4], attempted=4, failed=0, window_s=2.0,
                iterations=[100, 200, 300, 400], voxels=128 ** 3, dim=3,
                b1_call_bytes=peaks.b1_bytes(128 ** 3), b2_call_bytes=peaks.b2_bytes(128 ** 3))
    base.update(kw)
    return harness.Record(**base)


def _events():
    """A 10 ms stretch: B2's two kernels, B1, a copy on a second stream
    overlapping B2, a device-side copy of a host span, and host spans."""
    return [
        Event(False, TRACED, 0, 10 * MS),
        Event(False, "portbench.solve", 0, 9 * MS),
        Event(False, "cudaGraphLaunch", 6 * MS, 9 * MS),
        Event(True, "portbench.solve", 0, 9 * MS),  # the profiler's device-side copy
        Event(True, "void terms_kernel(Args)", 1 * MS, 3 * MS),
        Event(True, "void sobolev_update_kernel<3>(Args)", 3 * MS, 4 * MS),
        Event(True, "void warp_field_cm_kernel<unsigned int>(float const*)", 4 * MS, 5 * MS),
        Event(True, "Memcpy DtoD", 2 * MS, 6 * MS),
        Event(True, "void terms_kernel(Args)", -2 * MS, 1 * MS),  # clipped to the stretch
    ]


def test_busy_union_counts_overlap_once():
    assert busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert busy_union([]) == 0


def test_short_names():
    assert short_name("void terms_kernel(Args)") == "terms_kernel"
    assert short_name("void sobolev_update_kernel<3>(Args)") == "sobolev_update_kernel<3>"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, at::native::"
                      "FillFunctor<float>, std::array<char*, 1ul> >(int, F, A)") == \
        "at::native::vectorized_elementwise_kernel"


def test_reduce_events():
    t = reduce_events(_events(), first=1, stop=3, wall_s=0.5)
    assert t.span_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.006)  # [0, 6) ms: the copy overlaps B2
    assert t.kernel_time(peaks.B2_KERNELS) == pytest.approx(0.004)  # 1 + 2 + 1 ms
    assert t.kernel_time(peaks.B1_KERNELS) == pytest.approx(0.001)
    assert "portbench.solve" not in t.kernel_s
    assert t.idle_gaps[0] == ("portbench.solve / cudaGraphLaunch", pytest.approx(0.004))
    assert (t.first, t.stop, t.wall_s) == (1, 3, 0.5)
    assert reduce_events([e for e in _events() if not e.device]) is None
    assert reduce_events([e for e in _events() if e.name != TRACED]) is None


def _readings(trace=True, **kw):
    t = reduce_events(_events(), first=1, stop=3, wall_s=0.5) if trace else None
    return harness.Readings(_record(**kw), t, 1)


def _read(name, readings):
    return cells.reader(name).read(readings)


def test_metric_files_split_by_name():
    assert cells.metric_path("b2_roofline.solves").name == "b2_roofline.py"
    assert cells.metric_path("device_idle_pct.frames").name == "device_idle_pct.py"
    assert cells.metric_path("iters_per_solve").name == "iters_per_solve.py"


def test_kernel_rooflines():
    r = _readings()
    # Requests 1 and 2 ran in the stretch: 500 B2 calls, 502 B1 calls.
    assert r.traced_calls() == {"b1": 502, "b2": 500}
    b2 = 500 * peaks.b2_bytes(128 ** 3) / peaks.HBM_BYTES_PER_S / 0.004
    b1 = 502 * peaks.b1_bytes(128 ** 3) / peaks.HBM_BYTES_PER_S / 0.001
    assert _read("b2_roofline.solves", r) == pytest.approx(100 * b2)
    assert _read("b1_roofline.frames", r) == pytest.approx(100 * b1)
    assert _read("b2_roofline.solves", _readings(trace=False)) is None


def test_solve_roofline_leaves_the_traced_stretch_out():
    per_iter = peaks.iteration_bytes(128 ** 3) / peaks.HBM_BYTES_PER_S
    assert peaks.iteration_bytes(128 ** 3) == (5 + 8) * 128 ** 3 * 4  # 12.5 + 20.0 µs
    assert _read("solve_roofline.solves", _readings(trace=False)) == pytest.approx(
        100 * 1000 * per_iter / 2.0)
    # Requests 1 and 2 (500 iterations) and 0.5 s left out.
    assert _read("solve_roofline.frames", _readings()) == pytest.approx(
        100 * 500 * per_iter / 1.5)


def test_counts_spans_and_shares():
    r = _readings(io_wait_s=[0.001, 0.003])
    assert _read("iters_per_solve", r) == 250
    assert _read("iters_per_frame", r) == 250
    assert _read("io_wait_ms_per_frame", r) == pytest.approx(2.0)
    assert _read("io_wait_ms_per_frame", _readings()) is None
    assert _read("device_idle_pct.solves", r) == pytest.approx(40.0)
    # Busy 6 ms, B1 + B2 5 ms.
    assert _read("non_b1b2_device_pct", r) == pytest.approx(100 / 6)


def test_end_to_end_readers():
    r = _readings(trace=False, latencies_s=[i / 1000 for i in range(1, 101)], window_s=4.0)
    assert _read("pair_solves_per_s", r) == pytest.approx(25.0)
    assert _read("fused_frames_per_s", r) == pytest.approx(25.0)
    assert _read("pair_solve_p95_ms", r) == pytest.approx(95.0)
    assert _read("pair_solve_p95_ms.solves", r) == pytest.approx(95.0)  # the per-layer name
    assert _read("fused_frame_p95_ms", r) == pytest.approx(95.0)


def test_b2_block_bytes():
    plane, rows, halo = 512 * 512, 128, 5
    inner = peaks.b2_block_bytes(rows, plane, 1, 4, halo)
    edge = peaks.b2_block_bytes(rows, plane, 0, 4, halo)
    assert inner == ((5 * (rows + 2 * halo)) + 3 * rows) * plane * 4
    assert edge == ((5 * (rows + halo)) + 3 * rows) * plane * 4
    assert peaks.b2_block_bytes(512, plane, 0, 1, halo) == peaks.b2_bytes(512 ** 3)
