"""Probe of double-buffered haloed window copies: out = 2a + u₀ − u₁.

Port of ``experiments/dma_probe.py``. The TPU probe checks that manual
HBM→VMEM copies of haloed (x, y) windows, with origins clamped into the
volume and a two-slot buffer whose next copy starts before the current one
is waited on, give the exact result. The kernel (``csrc/dma_probe.cu``)
does the same with ``cp.async`` into two shared-memory stages; the output
tile is (``XB``, ``YB``, ``ZB``) and the window (``XW``, ``YW``, ``ZB``).

``main`` runs the JAX probe's shape with ``max|err| == 0``, then times the
kernel at 128³ and prints two rates: useful (3 reads and 1 write of the
volume) and moved (each input's window is (XW·YW)/(XB·YB) = 4.5 times its
tile; L2 may absorb part of that).

    python -m levelsetfusion_tpu_torch.experiments.dma_probe
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    best_ms,
    device_name,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops.kernels import _lib

SHAPE = (32, 64, 128)
TIMED_SHAPE = (128, 128, 128)
XB, YB, ZB = 8, 16, 8  # output tile (kXB, kYB, kZB of csrc/dma_probe.cu)
HX, HY = 5, 8  # halo
XW, YW = XB + 2 * HX, YB + 2 * HY

# Kernel launches since import or the last reset; callers set it to 0 to
# count the launches of one run.
launch_count = 0


def dma_probe_reference(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version: the elementwise expression."""
    return a * 2.0 + u[0] - u[1]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("dma_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lsf_dma_probe.argtypes = [p, p, p, i, i, i, p]
    lib.lsf_dma_probe.restype = i
    lib.lsf_dma_probe_error_string.argtypes = [i]
    lib.lsf_dma_probe_error_string.restype = ctypes.c_char_p
    return lib


def run(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``2a + u[0] − u[1]`` for ``a`` (X, Y, Z) and ``u`` (2, X, Y, Z),
    float32, contiguous, one device. X a multiple of XB with X ≥ XW, Y a
    multiple of YB with Y ≥ YW, Z a multiple of ZB. CUDA tensors run the
    kernel, CPU tensors the plain version."""
    global launch_count
    if a.ndim != 3 or tuple(u.shape) != (2, *a.shape):
        raise ValueError(
            f"want a (X, Y, Z) and u (2, X, Y, Z), got {tuple(a.shape)} and "
            f"{tuple(u.shape)}"
        )
    nx, ny, nz = a.shape
    if nx % XB or nx < XW or ny % YB or ny < YW or nz % ZB:
        raise ValueError(
            f"shape {tuple(a.shape)}: want X a multiple of {XB} and >= {XW}, "
            f"Y a multiple of {YB} and >= {YW}, Z a multiple of {ZB}"
        )
    _lib.require_f32_contiguous("a", a, a.device)
    _lib.require_f32_contiguous("u", u, a.device)
    if a.device.type == "cpu":
        return dma_probe_reference(a, u)
    if a.device.type != "cuda":
        raise ValueError(f"no dma_probe kernel for device {a.device}")
    lib = _library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.lsf_dma_probe(a.data_ptr(), u.data_ptr(), out.data_ptr(), nx, ny, nz,
                                _lib.stream_handle(a.device))
    _lib.check(err, lib.lsf_dma_probe_error_string, "dma_probe launch")
    launch_count += 1
    return out


def inputs(shape, device):
    """The JAX probe's inputs: standard normal from seed 0, then float32."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(u).to(device)


def main(device="cuda", shape=SHAPE, timed_shape=TIMED_SHAPE) -> dict:
    """Exactness at ``shape``, then the time and rates at ``timed_shape``."""
    device = resolve_device(device)
    a, u = inputs(shape, device)
    err = float(torch.max(torch.abs(run(a, u) - dma_probe_reference(a, u))))
    if err != 0.0:
        raise AssertionError(f"dma_probe at {shape}: max|err| {err} != 0")
    a, u = inputs(timed_shape, device)
    ms = best_ms(lambda: run(a, u), device, repeats=20)
    vol = 4 * int(np.prod(timed_shape))
    moved = (3 * XW * YW / (XB * YB) + 1) * vol
    out = {
        "shape": list(shape), "max_abs_err": err, "timed_shape": list(timed_shape),
        "device": device_name(device), "ms": ms,
        "useful_gbs": 4 * vol / (ms * 1e-3) / 1e9,
        "moved_gbs": moved / (ms * 1e-3) / 1e9,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
