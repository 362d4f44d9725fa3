"""The timer of the experiment scripts.

The JAX scripts time a chain of N calls inside one jit against a shorter
chain and difference the two, to cancel a dispatch floor of tens of
milliseconds. Here each call is timed with CUDA events after a warm-up;
where a script reports "per pass" or "per call" from such a difference, the
port keeps the difference, so that its rows mean the same thing. On a CPU
device (the tests) the host clock stands in, and every result names the
device it ran on.
"""

from __future__ import annotations

import time

import torch

# The CLI's device check: raises for "cuda" without CUDA.
from levelsetfusion_tpu_torch.cli import _device as resolve_device  # noqa: F401

SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def best_ms(fn, device: torch.device, repeats: int = 5) -> float:
    """Least time of one call of ``fn`` over ``repeats`` calls, in ms, after
    one warm-up call: CUDA events on a CUDA device, the host clock on the
    CPU. On the card a spin of about a millisecond is queued before the
    start event, so that the host has enqueued ``fn``'s launches by the
    time the device reaches them and the events time the device's work,
    not the host's (as long as enqueueing takes less than the spin)."""
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def differenced_ms(fn_long, fn_short, units: int, device: torch.device,
                   repeats: int = 5) -> float:
    """ms per unit of work, where ``fn_long`` does ``units`` more units than
    ``fn_short``: (best(long) - best(short)) / units."""
    return (best_ms(fn_long, device, repeats) - best_ms(fn_short, device, repeats)) / units
