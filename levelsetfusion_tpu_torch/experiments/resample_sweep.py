"""What holds the resample kernel (B1) back? Builds variants of
``csrc/resample.cu`` made by text substitutions (a design feature taken out,
the x-chunk length fixed, the x walk unrolled), holds each variant that keeps the
value against the plain version (exactly), and times the kernel of each at
128³ on the device (``torch.profiler``) on two warps:

- ``random``: bench's uniform ±2 warp (chip_smoke.py phase 6's inputs), whose
  corner reads scatter;
- ``solve``: the warp of config3's converged solve on the card, with its live
  field, which the solve loop resamples.

Variants that remove work (``timing_only``) compute wrong values on
purpose: they say what that work costs. Prints one JSON row per variant and
repeat, each naming the device.

    python -m levelsetfusion_tpu_torch.experiments.resample_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from levelsetfusion_tpu_torch.cli import _grid, _pair_3d
from levelsetfusion_tpu_torch.experiments import _sweep
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels import _lib
from levelsetfusion_tpu_torch.ops.kernels import resample as rs
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import to_component_major
from levelsetfusion_tpu_torch.utils.config import PRESETS

SOURCE = _lib.SOURCE_DIR / "resample.cu"
BUILD = _lib.BUILD_DIR / "resample_sweep"
SHAPE, RAGGED = (128, 128, 128), (37, 50, 61)
PRESET = "config3_3d_full_energy"
REPEATS = 2
CALLS = 100  # calls a variant's device time is averaged over

_CHUNK = ("  int64_t chunk = std::max<int64_t>(kMinXChunk, "
          "ceil_div(nx * tiles_z * tiles_y, wave));")
_SAMPLE = "  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);"
_GUARDED = "      r[c] = inb ? __ldg(live + ((Off)cx * plane + (Off)cy * (Off)nz + (Off)cz)) : 1.0f;"
_X_LOOP = "    for (int x = x_begin; x < x_end; ++x, v += plane) {"

# name -> (substitutions, timing_only). The timing-only variants compute
# wrong values on purpose: they say what the part they remove costs.
VARIANTS = {
    "base": ([], False),
    "no_cache_hints": ([("  return __ldcs(p);", "  return __ldg(p);"),
                        ("  __stcs(p, v);", "  *p = v;")], False),
    "no_interior_fast_path": ([("  if (interior) {", "  if (false) {")], False),
    "x_chunk_1": ([(_CHUNK, "  int64_t chunk = 1;")], False),
    "x_chunk_16": ([(_CHUNK, "  int64_t chunk = 16;")], False),
    "x_unroll_2": ([(_X_LOOP, "#pragma unroll 2\n" + _X_LOOP)], False),
    "streams_only": ([(_SAMPLE, "  return __fadd_rn(__fadd_rn(px, py), pz);\n" + _SAMPLE)],
                     True),
    "no_guarded_loads": ([(_GUARDED, "      r[c] = 1.0f;")], True),
}


def variant_source(name: str) -> str:
    """``csrc/resample.cu`` with the variant's substitutions; each anchor
    must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name][0], name)


def _kernel_key(mangled: str):
    """``off32`` or ``off64`` for an instantiation of
    ``warp_field_cm_kernel<Off>``."""
    if "warp_field_cm_kernel" not in mangled:
        return None
    return "off64" if mangled.split("warp_field_cm_kernel", 1)[1].startswith("ImE") else "off32"


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"resample_{name}", BUILD)
    return name, lib, _sweep.registers(log, _kernel_key)


def _random_inputs(device):
    """chip_smoke.py phase 6's live field (bench's in-band fields, seed 0)
    and a uniform ±2 component-major warp."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(SHAPE).astype(np.float32)
    live = torch.from_numpy(np.tanh(np.roll(base, 1, axis=0) * 0.3)).to(device)
    warp = torch.from_numpy(rng.uniform(-2.0, 2.0, (3,) + SHAPE).astype(np.float32)).to(device)
    return live, warp


def _solve_inputs(device):
    """config3's live field and the warp of its converged solve."""
    cfg = PRESETS[PRESET]
    canonical, live = _pair_3d(cfg, _grid(cfg), device)
    res = solve_single_level(canonical, live, cfg.solver)
    return live, to_component_major(res.warp)


def _ragged_inputs(device):
    rng = np.random.default_rng(2)
    live = torch.from_numpy(np.tanh(rng.standard_normal(RAGGED)).astype(np.float32)).to(device)
    warp = torch.from_numpy(rng.uniform(-6.0, 6.0, (3,) + RAGGED).astype(np.float32)).to(device)
    return live, warp


def _device_us(live, warp) -> float:
    """The kernel's device µs per call over CALLS calls (torch.profiler)."""
    return sum(_sweep.kernel_us(lambda: rs.warp_field_cm(live, warp), CALLS).values())


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("resample_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    warps = {"random": _random_inputs(device), "solve": _solve_inputs(device)}
    checks = [*warps.values(), _ragged_inputs(device)]
    wants = [rs.warp_field_cm_reference(live, warp) for live, warp in checks]
    library = rs._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = rs.bind(ctypes.CDLL(str(path)))
                rs._library = lambda lib=lib: lib
                err = None
                if not VARIANTS[name][1]:
                    err = 0.0
                    for (live, warp), want in zip(checks, wants):
                        got = rs.warp_field_cm(live, warp)
                        err = max(err, float(torch.max(torch.abs(got - want))))
                    if err != 0.0:
                        raise AssertionError(f"{name}: max|Δ| {err:.3e} against the plain "
                                             f"version")
                row = {"variant": name, "repeat": rep, "registers": regs, "max_abs_err": err,
                       **{f"us_{tag}": _device_us(live, warp)
                          for tag, (live, warp) in warps.items()},
                       "device": device_name(device)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        rs._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
