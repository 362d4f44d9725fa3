"""What sets the time of B4 and B5 on their ring: occupancy or
instructions? Builds variants of ``csrc/resample_variants.cu`` made by text
substitutions, holds each against the plain version (exactly), and times
B4's three inner loops (``run_vmemfull``: fori, chunk, unroll) and B5's two
(``run_v7``: chunk, unroll) at 128³ on ``resample_variants.inputs``
(``torch.profiler``, device µs):

- ``base``: tiles of 8 y rows (512 threads, two voxels a thread a step), a
  47 KB ring; launch bounds of four CTAs (64 warps, 32 registers) an SM for
  fori, two (32 warps, 64 registers) for chunk and unroll (B5's too); B5's
  chunk sums a thread's two voxels of a step together, its unroll one
  voxel at a time;
- ``ty4``, ``ty16``: tiles of 4 or 16 y rows (one or four voxels a thread a
  step; 32 or 75 KB rings);
- ``ctas2``, ``ctas3``: every loop's launch bounds at two or three CTAs an
  SM (64 or 40 registers a thread);
- ``one_cta``: the shared memory padded so that one CTA (16 warps) holds an
  SM;
- ``prefetch``: fori's pair loop (``resample_z.cuh``'s ``pair_sum``) loading
  pair t + 1's table entry and values before it sums pair t;
- ``v7_single``: B5's chunk one voxel at a time, as its unroll;
- ``v7_generic``: B5's loads by C++ indexing of the generic shared pointer
  in place of 32-bit shared addresses;
- ``v7_unroll_paired``: B5's unroll summing the two voxels together too.

Each row names the device and gives the ring kernels' registers, spills and
stack frames, and their SASS a voxel with its local loads and stores
(``ring_kernel<loop, tents_once>``).

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
_PAIRED = "constexpr bool kRingPaired = L == kChunk;"
# B5's loads: C++ indexing of the generic shared pointer in place of 32-bit
# shared addresses.
_GENERIC = [
    ("      const unsigned o = (unsigned)(cy * kLane + slot_off[cx]) * (unsigned)sizeof(float);\n",
     "      const float* rw = smem + (r + cy) * kLane + slot_off[cx];\n"),
    ("zmix(zs[k], ld_shared(a0[k] + o), ld_shared(a1[k] + o))",
     "zmix(zs[k], rw[k * kRowStep * kLane + zs[k].z0c], rw[k * kRowStep * kLane + zs[k].z1c])"),
]

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
    "v7_single": [(_PAIRED, "constexpr bool kRingPaired = false;")],
    "v7_generic": _GENERIC,
    "v7_unroll_paired": [(_PAIRED, "constexpr bool kRingPaired = L == kChunk || L == kUnroll;")],
}
CALLS_OF = {**{f"vf_{i}": ("run_vmemfull", i) for i in rv.VMEMFULL_INNERS},
            **{f"v7_{s}": ("run_v7", s) for s in rv.V7_STRUCTURES}}


def variant_source(name: str) -> str:
    """``csrc/resample_variants.cu``, ``resample_z.cuh`` inlined, with the
    variant's substitutions; each anchor must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name], name, inline=("resample_z.cuh",))


def _is_ring_kernel(mangled: str):
    return _sweep.kernel_name(mangled) if "ring_kernel" in mangled else None


def sass_loops(name: str) -> dict:
    """(trips, voxels) of each ring kernel's innermost loop with shared
    loads in variant ``name``, for ``_sweep.sass_per_voxel``: fori's pair
    loop runs 36 times a voxel, a chunk's cy loop 6 times (for a step's
    voxels at once where they are summed together), an unroll's voxel loop
    once a voxel (none where its voxels are summed together)."""
    vox = {"ty4": 1, "ty16": 4}.get(name, 2)  # voxels a thread a step
    paired = {"v7_single": (), "v7_unroll_paired": (2, 3)}.get(name, (2,))
    return {"ring_kernel<0,0>": (_sweep.PAIRS, 1), "ring_kernel<2,0>": (6, 1),
            "ring_kernel<3,0>": (1, 1),
            "ring_kernel<2,1>": (6, vox if 2 in paired else 1),
            "ring_kernel<3,1>": (1, vox if 3 in paired else 1)}


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
                for label, (entry, loop) in CALLS_OF.items():
                    def call(entry=entry, loop=loop):
                        return getattr(rv, entry)(field, warp, loop)
                    err = float(torch.max(torch.abs(call() - want)))
                    if err != 0.0:
                        raise AssertionError(f"{name} {label}: max|Δ| {err:.3e} against the "
                                             f"plain version")
                    row[f"us_{label}"] = sum(_sweep.kernel_us(call, CALLS).values())
                if rep == 0:
                    row["sass"] = _sweep.sass_per_voxel(path, set(regs), sass_loops(name))
                row["device"] = device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        rv._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
