"""The traced run: ``torch.profiler`` over a bounded stretch of the window,
reduced to device time by kernel, the device-busy union and the longest
idle gaps.

The stretch starts at the first request boundary (a ``tick``) at or after
``START_SHARE`` of the window and stops at the first boundary at least
``STRETCH_S`` seconds and ``MIN_REQUESTS`` requests later, so the trace stays
small whatever the window's length. The profiler is started and stopped once
in set-up (``Tracer.warm``): its first start in a process takes seconds. A ``portbench.traced`` span marks the stretch on the host; device
events are clipped to it. The busy union is a frozen copy of
``chip_smoke.py::_device_busy_us``: the union of the device events'
intervals, so that work on two streams at once counts once.

Spans named ``portbench.*`` are the benchmark's own (around its calls into
each layer of the program); an idle gap is named by the innermost such span
and the innermost other host operation under way at its middle.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

START_SHARE = 0.25
STRETCH_S = 1.0
MIN_REQUESTS = 3  # the stretch also holds at least this many requests
TOP = 10
TRACED = "portbench.traced"


class Event(NamedTuple):
    """One profiler event: on the device or on the host, ns."""

    device: bool
    name: str
    start: int
    end: int


class TraceResult(NamedTuple):
    span_s: float  # the traced stretch, profiler clock
    busy_s: float  # union of the device events inside it
    kernel_s: Dict[str, float]  # device seconds by short name
    device_ops: List[Tuple[str, float]]  # the TOP names by device seconds
    idle_gaps: List[Tuple[str, float]]  # the TOP gaps, named by the host's work
    first: int  # requests [first, stop) ran inside the stretch
    stop: int
    wall_s: float = 0.0  # the stretch on the window's clock, profiler start to stop

    def kernel_time(self, prefixes: Sequence[str]) -> float:
        """Device seconds of the kernels whose short name starts with one of
        ``prefixes``."""
        return sum(s for k, s in self.kernel_s.items() if k.startswith(tuple(prefixes)))


def short_name(name: str) -> str:
    """A device event's name without its arguments, namespaces or (for
    PyTorch's own kernels) template arguments (``chip_smoke.py``'s rule)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    return name if len(name) < 40 else name.split("<")[0]


def _kineto_events(prof) -> List[Event]:
    """The raw events of a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:  # older releases count µs
            start, dur = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append(Event(e.device_type() == cuda, e.name(), start, start + dur))
    return out


def busy_union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def _gaps(intervals, lo, hi):
    """The idle ``(start, end)`` stretches of [lo, hi) outside the union."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, start))
        reach = max(reach, end)
    if hi > reach:
        out.append((reach, hi))
    return out


def _gap_label(host: List[Event], at: float) -> str:
    """The innermost ``portbench.*`` span and the innermost other host
    operation running at ``at``."""
    ours = other = None
    for e in host:
        if e.start <= at < e.end and e.name != TRACED:
            if e.name.startswith("portbench."):
                if ours is None or e.start >= ours.start:
                    ours = e
            elif other is None or e.start >= other.start:
                other = e
    parts = [e.name for e in (ours, other) if e is not None]
    return " / ".join(parts) or "host outside any span"


def reduce_events(events: List[Event], first: int = 0, stop: int = 0,
                  wall_s: float = 0.0) -> Optional[TraceResult]:
    """The stretch's numbers from its events, or None without a
    ``portbench.traced`` span or without a device event inside it. Device
    events named ``portbench.*`` are the profiler's device-side copies of
    the host spans, not device work, and are left out."""
    marks = [e for e in events if not e.device and e.name == TRACED]
    if not marks:
        return None
    mark = max(marks, key=lambda e: e.end - e.start)
    lo, hi = mark.start, mark.end
    device = [e for e in events if e.device and e.end > lo and e.start < hi
              and not e.name.startswith("portbench.")]
    if not device:
        return None
    clipped = [(max(e.start, lo), min(e.end, hi)) for e in device]
    kernel_ns: Dict[str, float] = {}
    for e, (s, t) in zip(device, clipped):
        key = short_name(e.name)
        kernel_ns[key] = kernel_ns.get(key, 0.0) + (t - s)
    host = [e for e in events if not e.device]
    gaps = sorted(_gaps(clipped, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    idle = [(_gap_label(host, 0.5 * (a + b)), (b - a) / 1e9) for a, b in gaps]
    ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceResult(
        span_s=(hi - lo) / 1e9,
        busy_s=busy_union(clipped) / 1e9,
        kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
        device_ops=[(k, v / 1e9) for k, v in ops],
        idle_gaps=idle,
        first=first,
        stop=stop,
        wall_s=wall_s,
    )


class Tracer:
    """The profiler over a bounded stretch of one window (a no-op when
    ``enabled`` is false). The window's loop calls ``tick(i)`` before
    request ``i``; on several ranks, rank 0's ``decide`` is broadcast and
    every rank ``apply``s it, so all profile the same requests."""

    def __init__(self, enabled: bool, device_is_cuda: bool = True):
        self.enabled = enabled
        self._cuda = device_is_cuda
        self._prof = None
        self._mark = None
        self._t0 = None
        self._started_at = None
        self.first = self.stop = 0
        self.done = False
        self.result: Optional[TraceResult] = None

    def begin_window(self, seconds: float) -> None:
        self._t0 = time.perf_counter()
        self._seconds = seconds

    def decide(self) -> int:
        """0: nothing; 1: start the stretch; 2: stop it (rank 0's clock)."""
        if not self.enabled or self.done:
            return 0
        now = time.perf_counter()
        if self._prof is None:
            return 1 if now - self._t0 >= START_SHARE * self._seconds else 0
        long_enough = now - self._started_at >= STRETCH_S
        return 2 if long_enough and self._ticks >= MIN_REQUESTS else 0

    def apply(self, command: int, index: int) -> None:
        if command == 1:
            self._start(index)
        elif command == 2:
            self._stop(index)
        elif self._prof is not None:
            self._ticks += 1

    def tick(self, index: int) -> None:
        self.apply(self.decide(), index)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start in a
        process takes seconds, which would otherwise fall in the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        with profile(activities=activities):
            torch.ones(8, device="cuda" if self._cuda else "cpu").sum().item()

    def close(self, index: int) -> None:
        """At the window's end: stop a stretch still running."""
        if self._prof is not None:
            self._stop(index)

    def span(self, name: str):
        """A ``portbench.<name>`` host span while tracing, else nothing."""
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")

    def _start(self, index: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._mark = torch.profiler.record_function(TRACED)
        self._mark.__enter__()
        self._started_at = time.perf_counter()
        self._ticks = 0
        self.first = index

    def _stop(self, index: int) -> None:
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.wall_s = time.perf_counter() - self._started_at
        self.stop = index
        self.done = True
        self._stopped, self._prof = self._prof, None

    def finish(self) -> Optional[TraceResult]:
        """After the window: reduce the stretch's events (``result``)."""
        if getattr(self, "_stopped", None) is not None:
            events = _kineto_events(self._stopped)
            self.result = reduce_events(events, self.first, self.stop, self.wall_s)
            self._stopped = None
            host = [e for e in events if not e.device]
            device = [e for e in events if e.device]
            if host and device:
                print(f"portbench: trace of requests [{self.first}, {self.stop}): "
                      f"{len(host)} host and {len(device)} device events; host "
                      f"{(max(e.end for e in host) - min(e.start for e in host)) / 1e9:.4f} s, "
                      f"device {(max(e.end for e in device) - min(e.start for e in device)) / 1e9:.4f} s, "
                      f"marks {[(e.end - e.start) / 1e9 for e in host if e.name == TRACED]}, "
                      f"window clock {self.wall_s:.4f} s", file=sys.stderr)
        return self.result
