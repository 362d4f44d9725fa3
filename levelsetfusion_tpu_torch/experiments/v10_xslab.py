"""The x-slab resample with an active-shift range (v10).

Port of ``experiments/v10_xslab.py``. ``run_v10`` computes the clamped
shift-enumeration resample of ``resample_variants`` (ux and uy clamped to
±2 inside the kernel, the warp passed raw), its pair loop restricted to the
shifts [⌊min u⌋ + K, ⌊max u⌋ + K + 1] per axis over each (xb-row slab, y
block of yb) (``csrc/v10_xslab.cu``). The kernel is two launches: a bounds
pass writes each (x plane, y block)'s min and max into a scratch allocated
per call, and a compute pass, whose CTAs walk x chunks of 8 y rows, folds
each slab's rows and sums the active pairs, so its grid does not depend on
xb.
A pair outside that range has weight exactly 0, so the value is the full
enumeration's: the plain version is ``resample_variants.shift_sum_reference``.

``main`` is the JAX script's: field tanh(0.3 N(0, 1)) from seed 0, then a
random warp (scale 1.5) and a smooth one (scale 0.5; the normal draw it
replaces is still made, so both packages see the same numbers), each with
xb in (4, 8, 16). Per case it prints the time per call as the script
defines it, (chain of 9 − chain of 1) / 8, and max|Δ| against the golden
``warp_field`` on the clamped warp.

    python -m levelsetfusion_tpu_torch.experiments.v10_xslab
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    device_name,
    differenced_ms,
    resolve_device,
)
from levelsetfusion_tpu_torch.experiments.resample_variants import (
    K,
    check_inputs,
    clamp_warp,
    shift_sum_reference,
)
from levelsetfusion_tpu_torch.ops.interpolation import warp_field
from levelsetfusion_tpu_torch.ops.kernels import _lib

SHAPE = (128, 128, 128)
XBS = (4, 8, 16)

# Kernel launches since import or the last reset; callers set it to 0 to
# count the launches of one run.
launch_count = 0


def run_v10_reference(field: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """Plain version: the full clamped enumeration (the skipped pairs add
    exact zeros)."""
    return shift_sum_reference(field, warp, "full")


_P, _I = ctypes.c_void_p, ctypes.c_int
# The prototypes of csrc/v10_xslab.cu's entry points, in order
# (tests/test_torch_resample_variants.py holds them together).
XSLAB_ARGTYPES = (
    _P, _P, _P, _P,  # field, warp, out, partial
    _I, _I, _I, _I, _I,  # nx, ny, nz, xb, yb
    _P,  # stream
)
PARTIALS_ARGTYPES = (_I, _I, _I, _I, _I)  # nx, ny, nz, xb, yb
CTAS_ARGTYPES = (_I, _I, _I, _I, _I, _I)  # nx, ny, nz, xb, yb, pass


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("v10_xslab")
    for name, argtypes, restype in (("lsf_v10_xslab", XSLAB_ARGTYPES, _I),
                                    ("lsf_v10_partials_len", PARTIALS_ARGTYPES, ctypes.c_int64),
                                    ("lsf_v10_ctas", CTAS_ARGTYPES, ctypes.c_int64),
                                    ("lsf_v10_xslab_error_string", (_I,), ctypes.c_char_p)):
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = restype
    return lib


def grids(shape, xb=8, yb=64) -> tuple:
    """CTAs of the kernel's two launches, (bounds pass, compute pass), for a
    field of ``shape`` (GPU only: asks the built library)."""
    lib = _library()
    return tuple(int(lib.lsf_v10_ctas(*shape, xb, yb, p)) for p in (0, 1))


def run_v10(field, warp, xb=8, yb=64, chunk=128) -> torch.Tensor:
    """The resample of ``field`` (X, Y, 128) at the raw ``warp`` (X, Y, 128,
    3), float32, contiguous, one device. The TPU grid's cuts: xb divides X,
    yb divides Y (a multiple of 8 or Y itself), and the x-chunk window
    ``chunk`` is a multiple of xb that divides X. CUDA tensors run the
    kernel, CPU tensors the plain version."""
    global launch_count
    check_inputs(field, warp, yb, K)
    nx, ny, nz = field.shape
    for name, v in (("xb", xb), ("chunk", chunk)):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    if nx % xb or chunk % xb or nx % chunk:
        raise ValueError(
            f"X = {nx}, xb = {xb}, chunk = {chunk}: want xb | chunk and chunk | X"
        )
    if field.device.type == "cpu":
        return run_v10_reference(field, warp)
    lib = _library()
    out = torch.empty_like(field)
    rows = lib.lsf_v10_partials_len(nx, ny, nz, xb, yb)
    if rows <= 0:
        raise ValueError(f"run_v10: the kernel refuses {tuple(field.shape)}, xb {xb}, yb {yb}")
    # Scratch per call: calls in flight at once share nothing.
    partial = torch.empty(rows, dtype=torch.int32, device=field.device)
    with torch.cuda.device(field.device):
        err = lib.lsf_v10_xslab(field.data_ptr(), warp.data_ptr(), out.data_ptr(),
                                partial.data_ptr(), nx, ny, nz, xb, yb,
                                _lib.stream_handle(field.device))
    _lib.check(err, lib.lsf_v10_xslab_error_string, "run_v10 launch")
    launch_count += 1
    return out


def inputs(shape, device):
    """The JAX script's field and its two warps, drawn in its order:
    ``field, [("random", 1.5, warp), ("smooth", 0.5, warp)]``. The smooth warp
    is as the script writes it: ux = 0.5 sin(x), uy = 0.5 cos(x) (the
    transpose lays the cosine along x) and uz = 0.5 sin(2z) over a grid of
    X points, so Z must equal X."""
    rng = np.random.default_rng(0)
    field = np.tanh(rng.standard_normal(shape) * 0.3).astype(np.float32)
    warps = []
    for scale, smooth in [(1.5, False), (0.5, True)]:
        w = rng.standard_normal(tuple(shape) + (3,)).astype(np.float32) * scale
        if smooth:
            xs = np.linspace(0, 2 * np.pi, shape[0], dtype=np.float32)
            w = np.stack([
                scale * np.sin(xs)[:, None, None] * np.ones(shape, np.float32),
                scale * np.cos(xs)[None, :, None].transpose(1, 0, 2) * np.ones(shape, np.float32),
                scale * np.sin(2 * xs)[None, None, :] * np.ones(shape, np.float32),
            ], axis=-1)
        tag = "smooth" if smooth else "random"
        warps.append((tag, scale, torch.from_numpy(w).to(device)))
    return torch.from_numpy(field).to(device), warps


def main(device="cuda", shape=SHAPE, xbs=XBS, yb=64, chunk=128, chains=(1, 9)) -> list:
    """One JSON row per (warp, xb): ms per call from the difference of two
    chains of calls, and max|Δ| against the golden resample."""
    device = resolve_device(device)
    field, warps = inputs(shape, device)
    n1, n2 = chains
    rows = []
    for tag, scale, warp in warps:
        golden = warp_field(field, clamp_warp(warp))
        for xb in xbs:
            err = float(torch.max(torch.abs(run_v10(field, warp, xb, yb, chunk) - golden)))

            def chain(n, xb=xb, warp=warp):
                for _ in range(n):
                    run_v10(field, warp, xb, yb, chunk)

            ms = differenced_ms(lambda: chain(n2), lambda: chain(n1), n2 - n1, device,
                                repeats=3)
            row = {"xb": xb, "warp": tag, "scale": scale, "shape": list(shape),
                   "ms_per_call": ms, "max_abs_err": err, "device": device_name(device)}
            print(json.dumps(row))
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
