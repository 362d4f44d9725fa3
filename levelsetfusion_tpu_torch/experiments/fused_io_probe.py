"""The fused gradient kernel's fixed costs: the same I/O plan with varying
bodies.

Port of ``experiments/fused_io_probe.py``. Inputs ``warped``, ``canon``
(X, Y, Z) and ``warp_cm`` (3, X, Y, Z), edge-padded by ``H`` = 5 along x
outside the kernel, as the fused kernel's halo; the kernel
(``csrc/fused_io_probe.cu``) writes three warp components through one of
three bodies:

- ``copy``: out_k = u_k;
- ``arith``: out_k = u_k + 0.1 (w − c);
- ``rolls``: out_k = u_k + 0.1 (box27(w) − c): per axis acc + roll(acc, +1)
  + roll(acc, −1), over the x-padded field along x (so the volume's end rows
  are replicated) and periodic along y and z, as the JAX body computes it.

The JAX script chains ``CHAIN`` calls on the same padded inputs in one jit
(its carry is ignored); ``main`` times ``CHAIN`` identical launches and
reports the time per call, and the effective rate of the plan's bytes (5
padded inputs and 3 outputs; the copy body touches only the warp's) against
the card's 3.35 TB/s.

    python -m levelsetfusion_tpu_torch.experiments.fused_io_probe
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.experiments._timing import (
    best_ms,
    device_name,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops.kernels import _lib

SHAPE = (128, 128, 128)
CHAIN = 20
H = 5  # kH of csrc/fused_io_probe.cu
BODIES = ("copy", "arith", "rolls")
XBS = (16, 32)
PEAK_GBS = 3350.0  # H100 SXM HBM3

# Kernel launches since import or the last reset; callers set it to 0 to
# count the launches of one run.
launch_count = 0


def pad(warped, canon, warp_cm):
    """Edge-pad each input by ``H`` along x (the first spatial axis)."""
    widths = (0, 0, 0, 0, H, H)
    we = F.pad(warped[None, None], widths, mode="replicate")[0, 0]
    ce = F.pad(canon[None, None], widths, mode="replicate")[0, 0]
    ue = F.pad(warp_cm[None], widths, mode="replicate")[0]
    return we, ce, ue


def fused_io_probe_reference(we, ce, ue, body: str) -> torch.Tensor:
    """Plain version, whole volume at once (the kernel's ``xb`` only shapes
    its grid): ``torch.roll`` along x wraps at the padded ends, which no
    interior row reads."""
    nx = we.shape[0] - 2 * H
    u = ue[:, H:H + nx]
    if body == "copy":
        return u.clone()
    acc = we
    if body == "rolls":
        for ax in range(3):
            acc = acc + torch.roll(acc, 1, ax) + torch.roll(acc, -1, ax)
    d = (acc - ce)[H:H + nx]
    return u + 0.1 * d


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("fused_io_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lsf_fused_io_probe.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.lsf_fused_io_probe.restype = i
    lib.lsf_fused_io_probe_error_string.argtypes = [i]
    lib.lsf_fused_io_probe_error_string.restype = ctypes.c_char_p
    return lib


def fused_io_probe(we, ce, ue, body: str, xb: int) -> torch.Tensor:
    """One call of the probe on x-padded inputs: ``we``, ``ce`` (X + 2H, Y,
    Z), ``ue`` (3, X + 2H, Y, Z), float32, contiguous, one device; X a
    multiple of ``xb``. Returns (3, X, Y, Z). CUDA tensors run the kernel,
    CPU tensors the plain version."""
    global launch_count
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if we.ndim != 3 or we.shape[0] <= 2 * H:
        raise ValueError(f"want we (X + {2 * H}, Y, Z), got {tuple(we.shape)}")
    if tuple(ce.shape) != tuple(we.shape) or tuple(ue.shape) != (3, *we.shape):
        raise ValueError(
            f"want ce {tuple(we.shape)} and ue {(3, *we.shape)}, got "
            f"{tuple(ce.shape)} and {tuple(ue.shape)}"
        )
    nx, ny, nz = we.shape[0] - 2 * H, we.shape[1], we.shape[2]
    if not isinstance(xb, int) or xb < 1 or nx % xb:
        raise ValueError(f"X = {nx} is not a multiple of xb = {xb}")
    for name, t in (("we", we), ("ce", ce), ("ue", ue)):
        _lib.require_f32_contiguous(name, t, we.device)
    if we.device.type == "cpu":
        return fused_io_probe_reference(we, ce, ue, body)
    if we.device.type != "cuda":
        raise ValueError(f"no fused_io_probe kernel for device {we.device}")
    lib = _library()
    out = torch.empty((3, nx, ny, nz), dtype=torch.float32, device=we.device)
    with torch.cuda.device(we.device):
        err = lib.lsf_fused_io_probe(
            we.data_ptr(), ce.data_ptr(), ue.data_ptr(), out.data_ptr(),
            nx, ny, nz, xb, BODIES.index(body), _lib.stream_handle(we.device),
        )
    _lib.check(err, lib.lsf_fused_io_probe_error_string, "fused_io_probe launch")
    launch_count += 1
    return out


def inputs(shape, device):
    """The JAX script's inputs: standard normal, seed 0."""
    rng = np.random.default_rng(0)
    warped = rng.standard_normal(shape).astype(np.float32)
    canon = rng.standard_normal(shape).astype(np.float32)
    warp_cm = rng.standard_normal((3,) + tuple(shape)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (warped, canon, warp_cm)]


def plan_bytes(shape) -> int:
    """Bytes of the I/O plan per call: 5 padded inputs and 3 outputs."""
    x, y, z = shape
    return 4 * (5 * (x + 2 * H) * y * z + 3 * x * y * z)


def main(device="cuda", shape=SHAPE, chain=CHAIN, xbs=XBS) -> list:
    """Time per call of each body and xb on padded inputs (the padding is
    outside the timed launches), with the plan's effective rate."""
    device = resolve_device(device)
    we, ce, ue = pad(*inputs(shape, device))
    rows = []
    for body in BODIES:
        for xb in xbs:
            def calls(body=body, xb=xb):
                for _ in range(chain):
                    fused_io_probe(we, ce, ue, body, xb)
            ms = best_ms(calls, device, repeats=3) / chain
            gbs = plan_bytes(shape) / (ms * 1e-3) / 1e9
            rows.append({"body": body, "xb": xb, "ms": ms, "gbs": gbs})
            print(f"{body:6s} xb={xb:<3d} {ms:8.4f} ms  {gbs:8.1f} GB/s "
                  f"({gbs / PEAK_GBS:.1%} of 3.35 TB/s)  [{device_name(device)}]")
    return rows


if __name__ == "__main__":
    main()
