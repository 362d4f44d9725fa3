"""Probe of haloed window copies in flight: out = 2a + u₀ − u₁.

Port of ``experiments/dma_probe.py``. The TPU probe checks that manual
HBM→VMEM copies of haloed (x, y) windows, with origins clamped into the
volume and a two-slot buffer whose next copy starts before the current one
is waited on, give the exact result. The kernel (``csrc/dma_probe.cu``)
stages the same windows on the H100 as an x-walking ring: a CTA owns a
column of ``YB`` rows in y and ``ZT`` floats in z, walks one chunk of x,
and keeps planes x ± ``HX`` of the column's ``YW``-row window resident in
shared memory while it computes plane x, ``AHEAD`` more planes in flight,
each plane copied once by the Tensor Memory Accelerator. ``plan`` cuts the
volume into columns and chunks (about one wave of one CTA an SM) and counts
the bytes the copies move.

``main`` runs the JAX probe's shape with ``max|err| == 0``, then times the
kernel at 128³ and prints two rates: useful (3 reads and 1 write of the
volume) and moved (the bytes the plan's copies read, and the output).

    python -m levelsetfusion_tpu_torch.experiments.dma_probe
"""

from __future__ import annotations

import ctypes
import dataclasses
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
XB, YB, ZB = 8, 16, 8  # the TPU tile: X, Y, Z multiples of these (csrc/dma_probe.cu)
HX, HY = 5, 8  # halo
XW, YW = XB + 2 * HX, YB + 2 * HY
ZT = 32  # z extent of a column (kZT)
AHEAD = 4  # planes in flight past the window (kAhead)
H100_SMS = 132  # the plan a CPU run reports is the H100's

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)  # lsf_dma_probe

# Kernel launches since import or the last reset; callers set it to 0 to
# count the launches of one run.
launch_count = 0


def dma_probe_reference(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version: the elementwise expression."""
    return a * 2.0 + u[0] - u[1]


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch for an (X, Y, Z) volume: ``columns`` (y tiles ×
    z tiles) × ``chunks`` CTAs, the ring's ``slots``, and the bytes its
    copies move."""

    shape: tuple
    zt: int
    ahead: int
    tiles_y: int
    tiles_z: int
    chunk: int  # planes of x a CTA computes (the last chunk may have fewer)
    chunks: int

    @property
    def columns(self) -> int:
        return self.tiles_y * self.tiles_z

    @property
    def ctas(self) -> int:
        return self.columns * self.chunks

    @property
    def slots(self) -> int:
        return 2 * HX + 1 + self.ahead

    def cta(self, b: int) -> dict:
        """What CTA ``b`` computes, as the kernel reads ``blockIdx.x``: planes
        [x0, x1), rows [y0, y0 + YB) from the window at ``oy``, z [z0, z1);
        it stages planes [s0, s1)."""
        nx, ny, nz = self.shape
        column = b % self.columns
        j, z0 = column % self.tiles_y, column // self.tiles_y * self.zt
        x0 = b // self.columns * self.chunk
        x1 = min(x0 + self.chunk, nx)
        return {"x0": x0, "x1": x1, "y0": j * YB,
                "oy": min(max(j * YB - HY, 0), ny - YW),
                "z0": z0, "z1": min(z0 + self.zt, nz),
                "s0": max(x0 - HX, 0), "s1": min(x1 + HX, nx)}

    @property
    def staged_planes(self) -> int:
        """Planes each column stages, over its chunks."""
        return sum(c["s1"] - c["s0"] for c in map(self.cta, range(0, self.ctas, self.columns)))

    @property
    def moved_bytes(self) -> int:
        """Bytes the copies read (three fields' windows of YW rows, the part
        of each box inside Z) and the output's write."""
        nx, ny, nz = self.shape
        return 4 * (3 * self.staged_planes * self.tiles_y * YW * nz + nx * ny * nz)


@functools.cache
def plan(shape, sms: int, zt: int = ZT, ahead: int = AHEAD) -> Plan:
    """Columns of ``YB`` rows by ``zt`` floats; x cut into chunks of equal
    length so that columns × chunks is at most one wave of ``sms`` CTAs (at
    least one chunk, at most X)."""
    nx, ny, nz = shape
    tiles_y, tiles_z = ny // YB, -(-nz // zt)
    want = max(1, min(nx, sms // (tiles_y * tiles_z)))
    chunk = -(-nx // want)
    return Plan(tuple(shape), zt, ahead, tiles_y, tiles_z, chunk, -(-nx // chunk))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry points' argument and result types on a loaded
    ``csrc/dma_probe.cu`` library (or a sweep's variant of it)."""
    lib.lsf_dma_probe.argtypes = list(ARGTYPES)
    lib.lsf_dma_probe.restype = _I
    lib.lsf_dma_probe_error_string.argtypes = [_I]
    lib.lsf_dma_probe_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_lib.load("dma_probe"))


@functools.cache
def sms_of(device: torch.device) -> int:
    """The SM count ``plan`` is given on ``device``: the card's, or the
    H100's for a CPU run."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(lib: ctypes.CDLL, a: torch.Tensor, u: torch.Tensor, chunks: int) -> torch.Tensor:
    """One launch of ``lib``'s kernel on CUDA tensors already checked by
    ``run``, x cut into ``chunks``."""
    global launch_count
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.lsf_dma_probe(a.data_ptr(), u.data_ptr(), out.data_ptr(), *a.shape, chunks,
                                _lib.stream_handle(a.device))
    _lib.check(err, lib.lsf_dma_probe_error_string, "dma_probe launch")
    launch_count += 1
    return out


def run(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``2a + u[0] − u[1]`` for ``a`` (X, Y, Z) and ``u`` (2, X, Y, Z),
    float32, contiguous, one device. X a multiple of XB with X ≥ XW, Y a
    multiple of YB with Y ≥ YW, Z a multiple of ZB. CUDA tensors run the
    kernel, CPU tensors the plain version."""
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
    return launch(_library(), a, u, plan(tuple(a.shape), sms_of(a.device)).chunks)


def inputs(shape, device):
    """The JAX probe's inputs: standard normal from seed 0, then float32."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(u).to(device)


def describe(p: Plan) -> dict:
    """The plan's numbers, as ``main`` and ``chip_smoke.py`` print them."""
    return {"columns": p.columns, "chunks": p.chunks, "chunk": p.chunk, "ctas": p.ctas,
            "slots": p.slots, "ahead": p.ahead, "zt": p.zt,
            "staged_planes": p.staged_planes, "moved_bytes": p.moved_bytes}


def main(device="cuda", shape=SHAPE, timed_shape=TIMED_SHAPE) -> dict:
    """Exactness at ``shape``, then the time and rates at ``timed_shape``."""
    device = resolve_device(device)
    a, u = inputs(shape, device)
    err = float(torch.max(torch.abs(run(a, u) - dma_probe_reference(a, u))))
    if err != 0.0:
        raise AssertionError(f"dma_probe at {shape}: max|err| {err} != 0")
    a, u = inputs(timed_shape, device)
    ms = best_ms(lambda: run(a, u), device, repeats=20)
    p = plan(tuple(timed_shape), sms_of(device))
    out = {
        "shape": list(shape), "max_abs_err": err, "timed_shape": list(timed_shape),
        "device": device_name(device), "ms": ms, "plan": describe(p),
        "useful_gbs": 16 * a.numel() / (ms * 1e-3) / 1e9,
        "moved_gbs": p.moved_bytes / (ms * 1e-3) / 1e9,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
