"""What sets B4's time on its ring: occupancy or instructions? Builds
variants of ``csrc/resample_variants.cu`` made by text substitutions, holds
each against the plain version (exactly), and times B4's three inner loops
(``run_vmemfull``: fori, chunk, unroll) at 128³ on
``resample_variants.inputs`` (``torch.profiler``, device µs):

- ``base``: tiles of 8 y rows (512 threads, two voxels a thread a step), a
  47 KB ring; launch bounds of four CTAs (64 warps, 32 registers) an SM for
  fori, two (32 warps, 64 registers) for chunk and unroll;
- ``ty4``, ``ty16``: tiles of 4 or 16 y rows (one or four voxels a thread a
  step; 32 or 75 KB rings);
- ``ctas2``, ``ctas3``: every loop's launch bounds at two or three CTAs an
  SM (64 or 40 registers a thread);
- ``one_cta``: the shared memory padded so that one CTA (16 warps) holds an
  SM;
- ``prefetch``: fori's pair loop (``resample_z.cuh``'s ``pair_sum``) loading
  pair t + 1's table entry and values before it sums pair t.

Each row names the device and gives the ring kernels' registers, spills and
stack frames, and their SASS a voxel with its local loads and stores.

    python -m levelsetfusion_tpu_torch.experiments.resample_variants_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from levelsetfusion_tpu_torch.experiments import _sweep
from levelsetfusion_tpu_torch.experiments import resample_variants as rv
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib

SOURCE = _lib.SOURCE_DIR / "resample_variants.cu"
BUILD = _lib.BUILD_DIR / "resample_variants_sweep"
REPEATS = 2
CALLS = 100  # calls a variant's device time is averaged over

_TY = "constexpr int kRingTY = 8;"
_CTAS = "constexpr int kRingCtas = L == kPairLoop ? 4 : 2;"

# name -> substitutions.
VARIANTS = {
    "base": [],
    "ty4": [(_TY, "constexpr int kRingTY = 4;")],
    "ty16": [(_TY, "constexpr int kRingTY = 16;")],
    "ctas2": [(_CTAS, "constexpr int kRingCtas = 2;")],
    "ctas3": [(_CTAS, "constexpr int kRingCtas = 3;")],
    "one_cta": [("constexpr int kRingSmem = kRingSlots * kRingSlotF * (int)sizeof(float);",
                 "constexpr int kRingSmem = 120 * 1024;")],
    "prefetch": _sweep.PAIR_PREFETCH,
}


def variant_source(name: str) -> str:
    """``csrc/resample_variants.cu``, ``resample_z.cuh`` inlined, with the
    variant's substitutions; each anchor must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name], name, inline=("resample_z.cuh",))


def _is_ring_kernel(mangled: str):
    return _sweep.kernel_name(mangled) if "ring_kernel" in mangled else None


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"resample_variants_{name}", BUILD)
    return name, lib, _sweep.registers(log, _is_ring_kernel)


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("resample_variants_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    field, warp = rv.inputs(rv.SHAPE, device)
    want = rv.shift_sum_reference(field, warp)
    library = rv._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = rv.bind(ctypes.CDLL(str(path)))
                rv._library = lambda lib=lib: lib
                row = {"variant": name, "repeat": rep, "registers": regs}
                for inner in rv.VMEMFULL_INNERS:
                    def call(inner=inner):
                        return rv.run_vmemfull(field, warp, inner)
                    err = float(torch.max(torch.abs(call() - want)))
                    if err != 0.0:
                        raise AssertionError(f"{name} vf_{inner}: max|Δ| {err:.3e} against the "
                                             f"plain version")
                    row[f"us_vf_{inner}"] = sum(_sweep.kernel_us(call, CALLS).values())
                if rep == 0:
                    row["sass"] = _sweep.sass_per_voxel(path, set(regs))
                row["device"] = device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        rv._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
