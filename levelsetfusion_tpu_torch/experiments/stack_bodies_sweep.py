"""Where should v8's and v8c's weight table live, and at what tile; and
at what tile should B8's levels run? Builds variants of
``csrc/stack_bodies.cu`` made by text substitutions, holds each against the
plain version (exactly), and times B7's two bodies and B8's level 4 at 128³
on ``bisect_kernel.inputs``' random stack (``torch.profiler``, device µs):

- ``base``: the table in shared memory after the ring, [entry][thread]; v8
  on tiles of TY = 4 y rows (512 threads, two CTAs an SM), v8c on TY = 1
  (128 threads, five CTAs an SM: 20 warps);
- ``v8c_ty4``, ``v8c_ty2``: v8c on tiles of 4 y rows (one CTA an SM: 16
  warps) or 2 (two CTAs of 256 threads: 16 warps);
- ``level_ty1``, ``level_ty2``: the levels on tiles of 1 y row (128
  threads, ten CTAs an SM: 40 warps) or 2 (256 threads, five CTAs: 40
  warps), against the base's 4 (512 threads, two CTAs: 32 warps);
- ``no_prefetch``: v8's and v8c's pair loop loading pair t's values in the
  step that sums it, not one step ahead;
- ``level_prefetch``: the levels' pair loop (``resample_z.cuh``'s
  ``pair_sum``) loading pair t + 1's table entry and values before it sums
  pair t;
- ``v8_one_cta``: v8 with its shared memory padded so that one CTA (16
  warps) holds an SM, as v8c's does: what v8c's occupancy costs;
- ``local_table``: the table as a per-thread array (local memory), one CTA
  an SM, the shared-memory carve-out at 40% so that L1 keeps the table
  (512 × 144 B for v8c).

Each row names the device and gives the kernels' registers, spills and
stack frames, and their SASS a voxel with its local loads and stores.

    python -m levelsetfusion_tpu_torch.experiments.stack_bodies_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from levelsetfusion_tpu_torch.experiments import _sweep, bisect_kernel, loop_cost
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib

SOURCE = _lib.SOURCE_DIR / "stack_bodies.cu"
BUILD = _lib.BUILD_DIR / "stack_bodies_sweep"
REPEATS = 2
CALLS = 100  # calls a variant's device time is averaged over

_GEOM_SMEM = ("  static constexpr int kSmemB = (kRingF + kEntries<B> * kThreadsT) * "
              "(int)sizeof(float);")
_GEOM_CTAS = ("  static constexpr int kCtasPerSm = std::min(233472 / (kSmemB + 1024), "
              "2048 / kThreadsT);")
_CACHE = "  static lsf_occ::WaveCache cache;"

# name -> substitutions.
VARIANTS = {
    "base": [],
    "v8c_ty4": [("constexpr int kV8cTY = 1;", "constexpr int kV8cTY = 4;")],
    "v8c_ty2": [("constexpr int kV8cTY = 1;", "constexpr int kV8cTY = 2;")],
    "level_ty1": [("constexpr int kLevelTY = 4;", "constexpr int kLevelTY = 1;")],
    "level_ty2": [("constexpr int kLevelTY = 4;", "constexpr int kLevelTY = 2;")],
    "no_prefetch": [
        ("    const float wn = weight(t + 1);\n", ""),
        ("    const float r0n = q0[pairs[t + 1].row * kUnit], r1n = q1[pairs[t + 1].row * kUnit];\n"
         "    acc = add_pair(acc, w, zmix(zs, r0, r1));\n    w = wn, r0 = r0n, r1 = r1n;\n",
         "    acc = add_pair(acc, weight(t), zmix(zs, q0[pairs[t].row * kUnit], "
         "q1[pairs[t].row * kUnit]));\n"),
    ],
    "level_prefetch": _sweep.PAIR_PREFETCH,
    "v8_one_cta": [(_GEOM_SMEM, "  static constexpr int kSmemB = B == kV8 ? 120 * 1024 : "
                                "(kRingF + kEntries<B> * kThreadsT) * (int)sizeof(float);")],
    "local_table": [
        ("  float* const tab = smem + G::kRingF + threadIdx.x;",
         "  float tab[kEntries<B> > 0 ? kEntries<B> : 1];  // local memory: indexed by the "
         "runtime pair"),
        ("  constexpr int kTabStride = TY * kLane;", "  constexpr int kTabStride = 1;"),
        (_GEOM_SMEM, "  static constexpr int kSmemB = kRingF * (int)sizeof(float);"),
        (_GEOM_CTAS, "  static constexpr int kCtasPerSm = 1;"),
        (_CACHE, _CACHE + "\n  cudaFuncSetAttribute((const void*)table_kernel<B, TY>,\n"
                          "      cudaFuncAttributePreferredSharedMemoryCarveout, 40);"),
    ],
}


def variant_source(name: str) -> str:
    """``csrc/stack_bodies.cu``, ``resample_z.cuh`` inlined, with the
    variant's substitutions; each anchor must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name], name, inline=("resample_z.cuh",))


def _is_table_kernel(mangled: str):
    return _sweep.kernel_name(mangled) if "table_kernel" in mangled else None


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"stack_bodies_{name}", BUILD)
    return name, lib, _sweep.registers(log, _is_table_kernel)


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("stack_bodies_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    stacked, warp, _ = bisect_kernel.inputs(device)
    calls = {**{w: lambda w=w: bisect_kernel.run_v8(stacked, warp, 64, w)
                for w in bisect_kernel.WHICH},
             "level4": lambda: bisect_kernel.run(stacked, warp, 4)}
    wants = {**{w: bisect_kernel.v8_reference(stacked, warp, w) for w in bisect_kernel.WHICH},
             "level4": bisect_kernel.bisect_reference(stacked, warp, 4)}
    library = loop_cost._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = loop_cost.bind(ctypes.CDLL(str(path)))
                loop_cost._library = lambda lib=lib: lib
                row = {"variant": name, "repeat": rep, "registers": regs}
                for which, call in calls.items():
                    err = float(torch.max(torch.abs(call() - wants[which])))
                    if err != 0.0:
                        raise AssertionError(f"{name} {which}: max|Δ| {err:.3e} against the "
                                             f"plain version")
                    row[f"us_{which}"] = sum(_sweep.kernel_us(call, CALLS).values())
                if rep == 0:
                    row["sass"] = _sweep.sass_per_voxel(
                        path, {n for n in regs if n.startswith("table_kernel")})
                row["device"] = device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        loop_cost._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
