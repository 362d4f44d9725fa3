"""The resample's design space: one function, the clamped shift-enumeration
resample, under several loop structures and bodies.

Port of ``experiments/resample_variants.py``. For a field (X, Y, 128) and a
channel-last warp (X, Y, 128, 3), ux and uy clamped to ±K (K = 2, N = 2K + 2
shifts per axis) and uz not, with P the field padded by +1 (K cells before
and K + 1 after, in x and in y)::

    out = (1 − w0 − w1) + Σ_{cy, cx < N} tent(uy − (cy − K)) · tent(ux − (cx − K))
                             · (w0 · P(x+cx, y+cy, z0) + w1 · P(x+cx, y+cy, z0+1))

with z0 = z + ⌊uz⌋, w0 = 1 − frac(uz) and w1 = frac(uz), each zeroed where
its z index falls outside [0, 128), the gathered index clipped, and
tent(t) = max(0, 1 − |t|). For |ux|, |uy| ≤ 2 this is the golden
``warp_field``. Three kernel entries (``csrc/resample_variants.cu``):

- ``run_variant`` (B3): the ``KERNELS`` table, each CTA staging its own
  window of the 6 padded x rows of one x row (``b3_geometry``); TIMING-ONLY
  bodies ``static00``/``noslice`` (rows fixed at shift (0, 0)),
  ``nogather`` (no z gather), ``passthrough`` (P(x, y, z) + ux) and
  ``onepair`` (the single shift (0, 0) with the centre tents);
- ``run_vmemfull`` (B4): each padded row staged once per range of x rows,
  inner loop ``fori``, ``chunk`` or ``unroll`` (``b4_geometry``);
- ``run_v7`` (B5): as B4 with the tent values computed once per voxel,
  structure ``chunk`` (a thread's two voxels of a step summed together) or
  ``unroll`` (``b5_geometry``).

``main`` takes the JAX script's variant names, ``vf_<inner>[_yb<N>]`` and
``v7_<structure>[_yb<N>]`` included, and prints per variant one JSON line:
µs per call (best of 5 after a warm-up) and, except for the TIMING-ONLY
variants, max|Δ| against the golden ``warp_field`` on the clamped warp.

    python -m levelsetfusion_tpu_torch.experiments.resample_variants [variant ...]
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.experiments._timing import (
    best_ms,
    device_name,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops.interpolation import TRUNCATION_FILL, warp_field
from levelsetfusion_tpu_torch.ops.kernels import _lib

K = 2
LANE = 128  # the z extent every variant takes
SHAPE = (128, 128, 128)
LOOPS = ("fori", "twolevel", "chunk", "unroll")  # loop codes of the C entry
BODIES = ("full", "static00", "noslice", "nogather", "passthrough", "onepair")
# The JAX script's KERNELS: variant -> (loop structure, body, y block).
KERNELS = {
    "passthrough": ("fori", "passthrough", 64),
    "onepair": ("fori", "onepair", 64),
    "v6": ("fori", "full", 64),
    "static00": ("fori", "static00", 64),
    "nogather": ("fori", "nogather", 64),
    "noslice": ("fori", "noslice", 64),
    "twolevel": ("twolevel", "full", 64),
    "chunk": ("chunk", "full", 64),
    "unroll": ("unroll", "full", 8),
    "yb128": ("fori", "full", 128),
}
TIMING_ONLY = ("static00", "nogather", "noslice", "passthrough", "onepair")
DEFAULT_NAMES = ("v6", "static00", "nogather", "noslice", "twolevel", "chunk", "yb128")
VMEMFULL_INNERS = ("fori", "chunk", "unroll")
V7_STRUCTURES = ("chunk", "unroll")
# B3's compile-time geometry (csrc/resample_variants.cu kTileRows, kCtaRows):
# a CTA owns one x row and 64 y rows and stages them 8 at a time, into two
# buffers of 6 x 13 x 128 floats.
B3_TILE_ROWS = 8
B3_CTA_ROWS = 64
B3_STAGE_ROWS = 64  # at most this many y rows a runtime-geometry B3 CTA stages at a time
RING_X_ROWS = 8  # x rows a runtime-geometry B4/B5 CTA walks
RING_Y_ROWS = 16  # at most this many y rows per runtime-geometry B4/B5 CTA
# The compile-time ring of B4 and B5 (csrc/resample_variants.cu kRingTY,
# kRingCtas): the (y tile, x row) steps of 8-row tiles in equal ranges, one a
# CTA, one wave of CTAs (its launch bounds' CTAs an SM for each inner loop,
# B5's chunk and unroll as B4's), each holding a ring of 7 x rows of 13
# padded y rows.
B4_TILE_ROWS = 8
B4_CTAS_PER_SM = {"fori": 4, "chunk": 2, "unroll": 2}
H100_SMS = 132

# Kernel launches per entry since import or the last reset; callers set the
# values to 0 to count the launches of one run.
launch_counts = {"run_variant": 0, "run_vmemfull": 0, "run_v7": 0}


def clamp_warp(warp: torch.Tensor, k: int = K) -> torch.Tensor:
    """The warp with ux and uy clamped to [-k, k] (the scripts' ``wc``)."""
    return torch.cat([warp[..., :2].clamp(-k, k), warp[..., 2:]], dim=-1)


def _tent(t):
    return torch.clamp_min(1.0 - torch.abs(t), 0.0)


def shift_sum_reference(field, warp, body="full", k=K) -> torch.Tensor:
    """Plain version of every kernel here: torch over the shifted views of
    the +1-padded field, in the kernels' order (acc0, then cy outer and cx
    inner); ``body`` is one of ``BODIES``."""
    n = 2 * k + 2
    nx, ny, _ = field.shape
    ux, uy, uz = warp[..., 0].clamp(-k, k), warp[..., 1].clamp(-k, k), warp[..., 2]
    padded = F.pad(field, (0, 0, k, k + 1, k, k + 1), value=TRUNCATION_FILL)
    nz = torch.floor(uz)
    fz = uz - nz
    z0 = torch.arange(field.shape[2], device=field.device) + nz.to(torch.int64)
    z0c, z1c = z0.clamp(0, LANE - 1), (z0 + 1).clamp(0, LANE - 1)
    zero = torch.zeros((), dtype=field.dtype, device=field.device)
    w0 = torch.where((z0 >= 0) & (z0 < LANE), 1.0 - fz, zero)
    w1 = torch.where((z0 + 1 >= 0) & (z0 + 1 < LANE), fz, zero)

    def rows(cy, cx):
        return padded[cx:cx + nx, cy:cy + ny]

    def gathered(r):
        return w0 * torch.gather(r, 2, z0c) + w1 * torch.gather(r, 2, z1c)

    if body == "passthrough":
        return rows(0, 0) + ux
    acc = (1.0 - w0 - w1) * TRUNCATION_FILL
    if body == "onepair":
        return acc + (_tent(uy) * _tent(ux)) * gathered(rows(0, 0))
    g00 = gathered(rows(0, 0)) if body in ("static00", "noslice") else None
    for cy in range(n):
        wy = _tent(uy - float(cy - k))
        for cx in range(n):
            if body == "full":
                g = gathered(rows(cy, cx))
            elif body == "nogather":
                r = rows(cy, cx)
                g = w0 * r + w1 * r
            else:
                g = g00
            acc = acc + (wy * _tent(ux - float(cx - k))) * g
    return acc


def _parse(name):
    """(entry, loop, body, yb) of a ``main`` variant name."""
    if name.startswith(("vf_", "v7_")):
        parts = name.split("_")  # {vf,v7}_<inner>[_yb<N>]
        yb = int(parts[2][2:]) if len(parts) > 2 else 64
        entry = "run_v7" if name.startswith("v7_") else "run_vmemfull"
        return entry, parts[1], "full", yb
    if name not in KERNELS:
        raise ValueError(f"unknown variant {name!r}")
    return ("run_variant", *KERNELS[name])


def resample_variant_reference(field, warp, variant="v6", k=K) -> torch.Tensor:
    """Plain version of a variant named as ``main`` names it."""
    return shift_sum_reference(field, warp, _parse(variant)[2], k)


_P, _I = ctypes.c_void_p, ctypes.c_int
# The prototypes of csrc/resample_variants.cu's entry points
# (tests/test_torch_resample_variants.py holds them together).
VARIANT_ARGTYPES = (
    _P, _P, _P,  # field, warp, out
    _I, _I, _I, _I, _I, _I,  # nx, ny, nz, loop, body, tents_once
    _I, _I, _I,  # yb, ty, xc
    _P,  # stream
)
TILED_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _P)  # the same, less tents_once, yb, ty, xc
RING_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)  # the same, less yb, ty, xc


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the library's entry points."""
    lib.lsf_resample_variant.argtypes = list(VARIANT_ARGTYPES)
    lib.lsf_resample_variant.restype = _I
    lib.lsf_resample_variant_tiled.argtypes = list(TILED_ARGTYPES)
    lib.lsf_resample_variant_tiled.restype = _I
    lib.lsf_resample_variant_ring.argtypes = list(RING_ARGTYPES)
    lib.lsf_resample_variant_ring.restype = _I
    lib.lsf_resample_variants_error_string.argtypes = [_I]
    lib.lsf_resample_variants_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_lib.load("resample_variants"))


def check_inputs(field, warp, yb, k) -> None:
    """The wrappers' contract: k = 2; field (X, Y, 128) and warp (X, Y, 128,
    3), float32, contiguous, one device; the TPU grid's y block ``yb`` divides
    Y and is a multiple of 8 or Y itself."""
    if k != K:
        raise ValueError(f"the kernels are built for k = {K}, got {k}")
    if field.ndim != 3 or tuple(warp.shape) != (*field.shape, 3):
        raise ValueError(
            f"want field (X, Y, {LANE}) and warp (X, Y, {LANE}, 3), got "
            f"{tuple(field.shape)} and {tuple(warp.shape)}"
        )
    nx, ny, nz = field.shape
    if nz != LANE:
        raise ValueError(f"Z must be {LANE}, got {nz}")
    if not isinstance(yb, int) or yb < 1 or ny % yb or (yb % 8 and yb != ny):
        raise ValueError(
            f"y block {yb!r} must divide Y = {ny} and be a multiple of 8 or Y itself"
        )
    if nx < 1:
        raise ValueError("X must be at least 1")
    _lib.require_f32_contiguous("field", field, field.device)
    _lib.require_f32_contiguous("warp", warp, field.device)
    if field.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no resample variant kernel for device {field.device}")


def b3_geometry(shape, variant="v6") -> dict:
    """The launch ``run_variant`` makes for a field of ``shape`` (a shape
    ``check_inputs`` accepts): the kernel (``"tiled"``, the compile-time
    geometry, where Y is a multiple of ``B3_TILE_ROWS``; else ``"window"``,
    the runtime one), the y rows it stages at a time, the padded y rows a
    staged x row holds, its dynamic shared bytes a CTA, and its CTAs."""
    nx, ny, _ = shape
    if ny % B3_TILE_ROWS == 0:
        rows = B3_TILE_ROWS + 2 * K + 1
        return {"kernel": "tiled", "tile_rows": B3_TILE_ROWS, "staged_rows": rows,
                "smem_bytes": 2 * (2 * K + 2) * rows * LANE * 4,
                "ctas": nx * -(-ny // B3_CTA_ROWS)}
    yb = min(KERNELS[variant][2], ny)
    ty = yb if yb <= B3_STAGE_ROWS else math.gcd(yb, B3_STAGE_ROWS)
    rows = ty + 2 * K + 1
    return {"kernel": "window", "tile_rows": ty, "staged_rows": rows,
            "smem_bytes": (2 * K + 2) * rows * LANE * 4, "ctas": nx * (ny // yb)}


def b4_geometry(shape, yb=64, inner="fori", sms=H100_SMS) -> dict:
    """The launch ``run_vmemfull`` makes for a field of ``shape`` at y block
    ``yb`` (a shape and yb ``check_inputs`` accepts): the kernel
    (``"ring"``, the compile-time geometry, where Y is a multiple of
    ``B4_TILE_ROWS``; else ``"window"``, the runtime one), the y rows a CTA
    stages at a time, the padded y rows a staged x row holds, its dynamic
    shared bytes a CTA, and its CTAs (for the ring: one wave on ``sms`` SMs
    at ``inner``'s ``B4_CTAS_PER_SM``, at most one a step)."""
    nx, ny, _ = shape
    slots = 2 * K + 3
    if ny % B4_TILE_ROWS == 0:
        rows = B4_TILE_ROWS + 2 * K + 1
        return {"kernel": "ring", "tile_rows": B4_TILE_ROWS, "staged_rows": rows,
                "smem_bytes": slots * rows * LANE * 4,
                "ctas": min(nx * (ny // B4_TILE_ROWS), sms * B4_CTAS_PER_SM[inner])}
    ty = math.gcd(yb, RING_Y_ROWS)
    rows = ty + 2 * K + 1
    return {"kernel": "window", "tile_rows": ty, "staged_rows": rows,
            "smem_bytes": slots * rows * LANE * 4, "ctas": -(-nx // RING_X_ROWS) * (ny // ty)}


def b5_geometry(shape, yb=64, structure="chunk", sms=H100_SMS) -> dict:
    """The launch ``run_v7`` makes, as ``b4_geometry`` gives it: B5 takes
    B4's ring where Y is a multiple of ``B4_TILE_ROWS`` (its chunk and
    unroll at the CTAs an SM of B4's) and the runtime window kernel
    elsewhere."""
    if structure not in V7_STRUCTURES:
        raise ValueError(f"structure must be one of {V7_STRUCTURES}, got {structure!r}")
    return b4_geometry(shape, yb, structure, sms)


def _launch(entry, kernel, field, warp, loop, body, args=()) -> torch.Tensor:
    """One launch of ``kernel``: B3's tiles (``"tiled"``), the ring of B4
    and B5 (``"ring"``, ``args`` = (tents_once,)), or the runtime-geometry
    kernel (``"window"``, ``args`` = (tents_once, yb, ty, xc))."""
    lib = _library()
    fn = {"tiled": lib.lsf_resample_variant_tiled, "ring": lib.lsf_resample_variant_ring,
          "window": lib.lsf_resample_variant}[kernel]
    out = torch.empty_like(field)
    with torch.cuda.device(field.device):
        err = fn(field.data_ptr(), warp.data_ptr(), out.data_ptr(), *field.shape,
                 LOOPS.index(loop), BODIES.index(body), *(int(a) for a in args),
                 _lib.stream_handle(field.device))
    _lib.check(err, lib.lsf_resample_variants_error_string, f"{entry} launch")
    launch_counts[entry] += 1
    return out


def run_variant(field, warp, variant="v6", k=K) -> torch.Tensor:
    """B3: a ``KERNELS`` variant, y block min(yb, Y), each CTA staging the
    window of one x row (``b3_geometry``); the warp unclamped. CUDA tensors
    run the kernel, CPU tensors the plain version."""
    if variant not in KERNELS:
        raise ValueError(f"variant must be one of {sorted(KERNELS)}, got {variant!r}")
    loop, body, yb = KERNELS[variant]
    yb = min(yb, field.shape[1]) if field.ndim == 3 else yb
    check_inputs(field, warp, yb, k)
    if field.device.type == "cpu":
        return shift_sum_reference(field, warp, body, k)
    geometry = b3_geometry(field.shape, variant)
    if geometry["kernel"] == "tiled":
        return _launch("run_variant", "tiled", field, warp, loop, body)
    return _launch("run_variant", "window", field, warp, loop, body,
                   (False, yb, geometry["tile_rows"], 1))


def _window(entry, field, warp, loop, ty, tents_once) -> torch.Tensor:
    """The runtime-geometry kernel on CTAs of RING_X_ROWS x rows by ``ty`` y
    rows."""
    return _launch(entry, "window", field, warp, loop, "full",
                   (tents_once, ty, ty, RING_X_ROWS))


def run_vmemfull(field, warp, inner="fori", k=K, yb=64) -> torch.Tensor:
    """B4: each padded row staged once per range of x rows (``b4_geometry``),
    ``inner`` in ``VMEMFULL_INNERS``. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    if inner not in VMEMFULL_INNERS:
        raise ValueError(f"inner must be one of {VMEMFULL_INNERS}, got {inner!r}")
    check_inputs(field, warp, yb, k)
    if field.device.type == "cpu":
        return shift_sum_reference(field, warp, "full", k)
    geometry = b4_geometry(field.shape, yb, inner)
    if geometry["kernel"] == "ring":
        return _launch("run_vmemfull", "ring", field, warp, inner, "full", (False,))
    return _window("run_vmemfull", field, warp, inner, geometry["tile_rows"], False)


def run_v7(field, warp, structure="chunk", k=K, yb=64) -> torch.Tensor:
    """B5: as ``run_vmemfull`` (``b5_geometry``) with the tent values once
    per voxel, ``structure`` in ``V7_STRUCTURES``. CUDA tensors run the
    kernel, CPU tensors the plain version."""
    if structure not in V7_STRUCTURES:
        raise ValueError(f"structure must be one of {V7_STRUCTURES}, got {structure!r}")
    check_inputs(field, warp, yb, k)
    if field.device.type == "cpu":
        return shift_sum_reference(field, warp, "full", k)
    geometry = b5_geometry(field.shape, yb, structure)
    if geometry["kernel"] == "ring":
        return _launch("run_v7", "ring", field, warp, structure, "full", (True,))
    return _window("run_v7", field, warp, structure, geometry["tile_rows"], True)


def variant_call(name):
    """The call ``main`` makes for a variant name: ``fn(field, warp)``."""
    entry, loop, _, yb = _parse(name)
    if entry == "run_variant":
        return functools.partial(run_variant, variant=name)
    if entry == "run_v7":
        return functools.partial(run_v7, structure=loop, yb=yb)
    return functools.partial(run_vmemfull, inner=loop, yb=yb)


def inputs(shape, device):
    """The JAX script's inputs: tanh(0.3 N(0, 1)) and a 1.5 N(0, 1) warp, seed 0."""
    rng = np.random.default_rng(0)
    field = np.tanh(rng.standard_normal(shape) * 0.3).astype(np.float32)
    warp = (rng.standard_normal(tuple(shape) + (3,)) * 1.5).astype(np.float32)
    return torch.from_numpy(field).to(device), torch.from_numpy(warp).to(device)


def main(device="cuda", names=None, shape=SHAPE) -> list:
    """One JSON row per variant: µs per call and, for the variants that keep
    the value, max|Δ| against the golden ``warp_field`` on the clamped warp."""
    device = resolve_device(device)
    field, warp = inputs(shape, device)
    golden = warp_field(field, clamp_warp(warp))
    rows = []
    for name in names or DEFAULT_NAMES:
        fn = variant_call(name)
        out = fn(field, warp)
        row = {
            "variant": name, "shape": list(shape),
            "us_per_call": best_ms(lambda: fn(field, warp), device) * 1e3,
            "max_abs_err_vs_golden": (None if name in TIMING_ONLY
                                      else float(torch.max(torch.abs(out - golden)))),
            "device": device_name(device),
        }
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
