"""What the program records of itself while a profiler runs
(``levelsetfusion_tpu_torch/utils/profiling.py``): each span name's calls and
host seconds, and its counters. In a traced run the profiler runs only for
the traced stretch (and an empty warm-up in set-up), so these cover the
stretch. A program that records none gives nothing."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def _profiling():
    from levelsetfusion_tpu_torch.utils import profiling

    return profiling


def spans() -> Dict[str, Dict[str, float]]:
    """``{name: {"calls", "host_s"}}`` of the program's spans."""
    fn = getattr(_profiling(), "spans", None)
    return fn() if fn is not None else {}


def counters() -> Dict[str, int]:
    fn = getattr(_profiling(), "counters", None)
    return fn() if fn is not None else {}


def per_request(r, names: Sequence[str], key: str) -> Optional[float]:
    """The sum of ``key`` (``calls`` or ``host_s``) over the spans ``names``
    a request of the traced stretch; None untraced or without them."""
    t, got = r.trace, spans()
    if t is None or t.stop <= t.first or not any(n in got for n in names):
        return None
    return sum(got[n][key] for n in names if n in got) / (t.stop - t.first)
