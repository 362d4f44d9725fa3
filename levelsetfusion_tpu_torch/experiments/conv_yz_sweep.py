"""What sets B12's banded products' time: warps or accumulator chains?
Builds variants of ``csrc/conv_yz.cu`` made by text substitutions, holds
each banded route against its plain version and times it per conv pass at
128³ on ``mxu_conv.inputs`` (``torch.profiler`` device µs of a
``REPS``-pass call less a one-pass call, over ``REPS - 1``):

- ``base``: 32 warps a CTA, 4 accumulators (output tiles) a warp;
- ``acc2``, ``acc8``: 2 or 8 accumulators a warp;
- ``warps8``, ``warps16``: 8 or 16 warps a CTA;
- ``warps8_acc2``, ``warps16_acc2``: both.

Each row names the device and gives the banded kernels' registers, spills
and stack frames.

    python -m levelsetfusion_tpu_torch.experiments.conv_yz_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from levelsetfusion_tpu_torch.experiments import _sweep, mxu_conv
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib

SOURCE = _lib.SOURCE_DIR / "conv_yz.cu"
BUILD = _lib.BUILD_DIR / "conv_yz_sweep"
SHAPE = (128, 128, 128)
REPEATS = 2
REPS = 129  # passes of the long call; the short call makes one
CALLS = 10  # calls a device time is averaged over

_WARPS = "constexpr int kBandThreads = 1024;"
_ACC = "constexpr int kAcc = 4;"


def _warps(n):
    return _WARPS, f"constexpr int kBandThreads = {32 * n};"


def _acc(n):
    return _ACC, f"constexpr int kAcc = {n};"


# name -> substitutions.
VARIANTS = {
    "base": [],
    "acc2": [_acc(2)],
    "acc8": [_acc(8)],
    "warps8": [_warps(8)],
    "warps16": [_warps(16)],
    "warps8_acc2": [_warps(8), _acc(2)],
    "warps16_acc2": [_warps(16), _acc(2)],
}


def variant_source(name: str) -> str:
    """``csrc/conv_yz.cu`` with the variant's substitutions; each anchor
    must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name], name)


def _is_banded(mangled: str):
    return _sweep.kernel_name(mangled) if "banded" in mangled else None


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"conv_yz_{name}", BUILD)
    return name, lib, _sweep.registers(log, _is_banded)


def _check(what: str, got, want, bf16: bool) -> None:
    """3×TF32 within 1e-5 of max|plain|; bf16 by chip_smoke's rule (1e-4 on
    all but 0.1% of the values, 1e-2 on all)."""
    err = torch.abs(got - want)
    if bf16:
        bad = float(torch.mean((err > 1e-4).float())) > 1e-3 or float(err.max()) > 1e-2
    else:
        bad = float(err.max()) > 1e-5 * float(torch.abs(want).max())
    if bad:
        raise AssertionError(f"{what}: max|Δ| {float(err.max()):.3e} against the plain version")


def _us_per_pass(route, a, cy, cz) -> float:
    def us(reps):
        return sum(_sweep.kernel_us(lambda: route(a, cy, cz, reps), CALLS).values())

    return (us(REPS) - us(1)) / (REPS - 1)


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("conv_yz_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    a, _, cy, cz = mxu_conv.inputs(SHAPE, device)
    routes = {
        "f32": (mxu_conv.conv_yz_banded_f32, mxu_conv.conv_yz_banded_reference, False),
        "bf16": (mxu_conv.conv_yz_banded_bf16, mxu_conv.conv_yz_banded_bf16_reference, True),
    }
    library = mxu_conv._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = mxu_conv.bind(ctypes.CDLL(str(path)))
                mxu_conv._library = lambda lib=lib: lib
                row = {"variant": name, "repeat": rep, "registers": regs}
                for key, (route, plain, bf16) in routes.items():
                    for reps in (1, 3):
                        _check(f"{name} {key} reps {reps}", route(a, cy, cz, reps),
                               plain(a, cy, cz, reps), bf16)
                    row[f"us_{key}"] = _us_per_pass(route, a, cy, cz)
                row["device"] = device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        mxu_conv._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
