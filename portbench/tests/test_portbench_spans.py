"""The per-layer metrics that read what the program records of itself while
the profiler runs (``lib/program.py``): each reads its hand-computed value a
request of the traced stretch, and None untraced, without its spans or on a
program that records none. On the card: the program's spans leave no
device-side copy, so the trace reduction's readings do not move."""

import pytest

from portbench.lib import cells, harness, peaks, program
from portbench.lib.tracing import TRACED, Event, reduce_events

MS = 1_000_000  # ns


def _readings(trace=True):
    record = harness.Record(
        latencies_s=[0.1, 0.2, 0.3, 0.4], attempted=4, failed=0, window_s=1.0,
        iterations=[32, 48, 16, 16], voxels=128 ** 3, dim=3,
        b1_call_bytes=peaks.b1_bytes(128 ** 3), b2_call_bytes=peaks.b2_bytes(128 ** 3))
    events = [Event(False, TRACED, 0, 10 * MS), Event(True, "void terms_kernel(A)", MS, 2 * MS)]
    # Requests 1 and 2 ran inside the stretch.
    return harness.Readings(record, reduce_events(events, 1, 3, 0.01) if trace else None, 1)


SPANS = {
    "lsf.solve": {"calls": 2, "host_s": 0.3},
    "lsf.solve.build": {"calls": 2, "host_s": 0.002},
    "lsf.solve.capture": {"calls": 2, "host_s": 0.040},
    "lsf.solve.release": {"calls": 2, "host_s": 0.018},
    "lsf.solve.flag_read": {"calls": 98, "host_s": 0.2},
    "lsf.solve.result_read": {"calls": 2, "host_s": 0.001},
    "lsf.frame.report_read": {"calls": 2, "host_s": 0.001},
    "lsf.io.prefetch_wait": {"calls": 2, "host_s": 0.0006},
}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(program, "spans", lambda: SPANS)
    monkeypatch.setattr(program, "counters", lambda: {"halo.bytes_sent": 1_386_217_472})


def _read(name, readings):
    return cells.reader(name).read(readings)


def test_metrics_per_request(recorded):
    r = _readings()
    assert _read("host_reads.solves", r) == 51  # (98 + 2 + 2) / 2
    assert _read("host_reads.frames", r) == 51
    assert _read("loop_setup_ms.solves", r) == pytest.approx(30.0)  # (2 + 40 + 18) / 2
    assert _read("prefetch_wait_ms.frames", r) == pytest.approx(0.3)
    assert _read("halo_mb.solves", r) == pytest.approx(693.108736)


NEW = ("host_reads.solves", "loop_setup_ms.solves", "prefetch_wait_ms.frames",
       "halo_mb.solves")


@pytest.mark.parametrize("name", NEW)
def test_metrics_read_nothing_untraced(recorded, name):
    assert _read(name, _readings(trace=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_metrics_read_nothing_without_spans(monkeypatch, name):
    monkeypatch.setattr(program, "spans", lambda: {"lsf.tsdf": {"calls": 2, "host_s": 0.1}})
    monkeypatch.setattr(program, "counters", lambda: {})
    assert _read(name, _readings()) is None


@pytest.mark.parametrize("name", NEW)
def test_metrics_read_nothing_from_a_program_that_records_none(monkeypatch, name):
    from levelsetfusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert program.spans() == {} and program.counters() == {}
    assert _read(name, _readings()) is None


@pytest.mark.card
def test_program_spans_leave_no_device_copy(card):
    """A kernel launched inside a program span: the span is a host event,
    no device event carries its name, and the reduction reads the same
    busy time and kernels as without the span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from levelsetfusion_tpu_torch.utils import profiling
    from portbench.lib import tracing

    x = torch.randn(1 << 22, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED):
            with profiling.span("lsf.test"):
                y = x.sin()
                with profiling.span("lsf.test.inner"):
                    y.cos_()
            torch.cuda.synchronize()
    events = tracing._kineto_events(prof)
    assert sorted(e.name for e in events if not e.device and e.name.startswith("lsf.")) == [
        "lsf.test", "lsf.test.inner"]
    assert not [e for e in events if e.device and e.name.startswith("lsf.")]
    kept = tracing.reduce_events(events)
    bare = tracing.reduce_events([e for e in events if not e.name.startswith("lsf.")])
    assert (kept.busy_s, kept.kernel_s) == (bare.busy_s, bare.kernel_s)
    assert profiling.spans()["lsf.test"]["calls"] >= 1
