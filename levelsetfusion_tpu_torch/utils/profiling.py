"""Tracing and profiling hooks. Twin of ``levelsetfusion_tpu/utils/profiling.py``.

- ``sync``: ``torch.cuda.synchronize`` (JAX's fetched a scalar, since
  ``block_until_ready`` did nothing on its remote TPU).
- ``device_time``: CUDA events around a call, a warm-up first, the minimum
  of ``repeats``. It measures the card or raises: no host-clock fallback.
- ``trace``: a ``torch.profiler`` trace (CUDA activity where CUDA is up)
  written as a Chrome trace into a directory (the CLI's ``--profile``).
- ``solver_roofline``: one solver iteration's time against the least time
  the card could take for its bytes, priced for the H100 (NVIDIA H100
  80GB HBM3 at a 700 W power limit: 3.35 TB/s).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch

H100_HBM_BYTES_PER_S = 3.35e12
F32 = 4


def sync(device=None) -> None:
    """Wait for the card's queued work (``torch.cuda.synchronize``)."""
    torch.cuda.synchronize(device)


def device_time(fn: Callable, *args, repeats: int = 5) -> float:
    """Seconds of ``fn(*args)`` on the card: CUDA events around each call
    after one warm-up call, the minimum of ``repeats``."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time measures the card: CUDA is not available")
    fn(*args)
    sync()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the scope, CPU and (where CUDA is up) CUDA
    activity; on exit the Chrome trace is written to
    ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def solver_roofline(shape, seconds_per_iter: float, dim: int = 3) -> Dict[str, float]:
    """One solver iteration at ``shape`` against the card's memory roofline:
    the bytes it must move, as the kernel table's bound column counts them
    (each input read once, each output written once, f32), over 3.35 TB/s.
    B1 reads the live field and the D-component warp and writes the warped
    field; B2 reads the warped field, the canonical and the warp and writes
    the new warp (its few statistics aside): at 128³ 12.5 µs + 20.0 µs.
    ``dim`` is kept for JAX's signature; the shape gives it."""
    voxels = 1
    for s in shape:
        voxels *= s
    d = len(shape)
    resample_bytes = (1 + d + 1) * voxels * F32
    fused_bytes = (1 + 1 + d + d) * voxels * F32
    mem_bound_s = (resample_bytes + fused_bytes) / H100_HBM_BYTES_PER_S
    return {
        "voxels": float(voxels),
        "seconds_per_iter": seconds_per_iter,
        "voxel_updates_per_s": voxels / seconds_per_iter,
        "memory_bound_seconds": mem_bound_s,
        "fraction_of_memory_roofline": mem_bound_s / seconds_per_iter,
    }
