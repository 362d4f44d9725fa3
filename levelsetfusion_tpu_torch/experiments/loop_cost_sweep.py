"""At what tile, how many voxels a thread and how many x rows in flight
should B9's ``loop_kernel`` run? Builds variants of ``csrc/stack_bodies.cu`` made by text
substitutions, holds each against the plain version (exactly), and times
the ten ``body/loop`` cases of ``loop_cost`` at 128³ on ``loop_cost.inputs``
(``torch.profiler``, device µs):

- ``base``: tiles of 4 y rows, two voxels a thread (rows r and r + 2: 256
  threads), the 86 KB ring, two CTAs (16 warps) an SM;
- ``one_voxel``: tiles of 4 rows, one voxel a thread (512 threads, two
  CTAs: 32 warps an SM, 64 registers a thread);
- ``tile2``: tiles of 2 rows, two voxels a thread (rows 0 and 1: 128
  threads), the 43 KB ring, five CTAs (20 warps) an SM;
- ``ahead2``: the base with two x rows in flight while a step sums (a ring
  of 8 slots, 96 KB: two CTAs an SM), fori reading its own pair table.

Each row names the device and gives the kernels' registers, spills and
stack frames, and the SASS a voxel of ``full`` under both loops.

    python -m levelsetfusion_tpu_torch.experiments.loop_cost_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from levelsetfusion_tpu_torch.experiments import _sweep, loop_cost
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib

SOURCE = _lib.SOURCE_DIR / "stack_bodies.cu"
BUILD = _lib.BUILD_DIR / "loop_cost_sweep"
REPEATS = 2
CALLS = 100  # calls a case's device time is averaged over

_TY = "constexpr int kLoopTY = 4;"
_V = "constexpr int kLoopV = 2;"
_AHEAD = "constexpr int kLoopAhead = 1;\n"
_PAIRS = ("    static_assert(kLoopSlots == kSlots, \"B9's ring reads table_kernel's "
          "kRingPairs\");\n    const Pair* pairs = kRingPairs.p[slot0];\n")

# name -> (substitutions, tile rows, voxels a thread).
VARIANTS = {
    "base": ([], 4, 2),
    "one_voxel": ([(_V, "constexpr int kLoopV = 1;")], 4, 1),
    "tile2": ([(_TY, "constexpr int kLoopTY = 2;")], 2, 2),
    "ahead2": ([(_AHEAD, "constexpr int kLoopAhead = 2;\n"),
                ("constexpr int kLoopSlots = kN + kLoopAhead;\n",
                 "constexpr int kLoopSlots = kN + kLoopAhead;\n__constant__ PairTable<kLoopSlots> "
                 "kLoopPairs = pair_table<kLoopSlots>(kLoopSlots, kN);\n"),
                (_PAIRS, "    const Pair* pairs = kLoopPairs.p[slot0];\n")], 4, 2),
}


def variant_source(name: str) -> str:
    """``csrc/stack_bodies.cu`` with the variant's substitutions; each
    anchor must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name][0], name)


def _is_loop_kernel(mangled: str):
    return _sweep.kernel_name(mangled) if "loop_kernel" in mangled else None


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"stack_bodies_{name}", BUILD)
    return name, lib, _sweep.registers(log, _is_loop_kernel)


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("loop_cost_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    stacked, warp = loop_cost.inputs(device)
    cases = [(b, lp) for lp in loop_cost.LOOP_KINDS for b in loop_cost.BODY_KINDS]
    wants = {b: loop_cost.loop_cost_reference(stacked, warp, b) for b in loop_cost.BODY_KINDS}
    library = loop_cost._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = loop_cost.bind(ctypes.CDLL(str(path)))
                loop_cost._library = lambda lib=lib: lib
                row = {"variant": name, "repeat": rep, "registers": regs}
                for body, loop in cases:
                    call = lambda b=body, lp=loop: loop_cost.run(stacked, warp, b, lp)  # noqa: E731
                    err = float(torch.max(torch.abs(call() - wants[body])))
                    if err != 0.0:
                        raise AssertionError(f"{name} {body}/{loop}: max|Δ| {err:.3e} against "
                                             f"the plain version")
                    row[f"us_{body}_{loop}"] = sum(_sweep.kernel_us(call, CALLS).values())
                if rep == 0:
                    _, tile, vox = VARIANTS[name]
                    full = {f"loop_kernel<4,{i},{tile},{vox}>": (loop_cost.NBODY, vox)
                            for i in range(len(loop_cost.LOOP_KINDS))}
                    row["sass"] = _sweep.sass_per_voxel(path, set(full), full)
                row["device"] = device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        loop_cost._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
