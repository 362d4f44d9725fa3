"""What sets B10's time: the ring's column width, its depth in flight, or
the copy instruction? Builds variants of ``csrc/dma_probe.cu`` made by text
substitutions, holds each exactly against the plain version at (24, 32, 8),
(40, 48, 72) and 128³, then times it at 128³ and 256³ (``torch.profiler``
device µs a call), beside the plain version and one ``torch.baddbmm``:

- ``zt16_p2`` … ``zt64_p6``: columns of 16, 32 or 64 floats in z (64-,
  128- or 256-byte rows) and 2, 4 or 6 planes in flight past the resident
  window (``zt32_p4`` is the shipped kernel). A ring whose 11 + P slots do
  not fit a CTA's shared memory is refused by the kernel's entry point;
  the row says so;
- ``zt32_p7``, ``zt16_p10``: the deepest rings that fit at 32 floats, and
  a deep one at 16;
- ``zt16_p4_2cta``: the plan cut for two CTAs an SM (two 90 KB rings), so
  that twice the chunks are in flight at once;
- ``ubox1``: u₀ and u₁ of a plane as two boxes, three copies a plane (the
  first cut) instead of two;
- ``rows``: each plane copied as 3 × YW row-wise 1-D ``cp.async.bulk``
  copies instead of tensor-map boxes;
- ``issue2``: a plane's two boxes issued by two threads in two warps, one
  each, instead of both by one thread;
- ``poll_warp``, ``poll_cta``: the barriers polled by lane 0 of each warp
  (then ``__syncwarp``), or by thread 0 alone (then a second
  ``__syncthreads`` a step), instead of by every thread.

Each row names the device and gives the kernel's registers, spills, stack
frame and the plan's CTAs.

    python -m levelsetfusion_tpu_torch.experiments.dma_probe_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from levelsetfusion_tpu_torch.experiments import _sweep, dma_probe
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib

SOURCE = _lib.SOURCE_DIR / "dma_probe.cu"
BUILD = _lib.BUILD_DIR / "dma_probe_sweep"
CHECKED = ((24, 32, 8), (40, 48, 72), (128, 128, 128))
TIMED = ((128, 128, 128), (256, 256, 256))
REPEATS = 2
CALLS = 20  # calls a device time is averaged over

_ZT = "constexpr int kZT = 32;"
_AHEAD = "constexpr int kAhead = 4;"
_TMA_ISSUE = (
    "  mbar_expect_tx(bar, kSlotBytes);\n"
    "  tma_load(dst, map_a, bar, z0, oy, plane, 0);\n"
    "  for (int c = 0; c < 2; c += kUBox)\n"
    "    tma_load(dst + (1 + c) * kFieldBytes, map_u, bar, z0, oy, plane, c);\n"
)
# The same plane as 3 x YW rows of min(kZT, Z - z0) floats, each one 1-D
# bulk copy completed on the slot's barrier (only the bytes inside Z move).
_ROW_ISSUE = (
    "  const uint32_t row = (uint32_t)min(kZT, p.nz - z0) * sizeof(float);\n"
    "  mbar_expect_tx(bar, 3u * kYW * row);\n"
    "  const int64_t vol = (int64_t)p.nx * p.ny * p.nz;\n"
    "  for (int r = 0; r < kYW; ++r) {\n"
    "    const int64_t g = ((int64_t)plane * p.ny + oy + r) * p.nz + z0;\n"
    "    const float* src[3] = {p.a + g, p.u + g, p.u + vol + g};\n"
    "    for (int f = 0; f < 3; ++f)\n"
    "      asm volatile(\n"
    "          \"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes\"\n"
    "          \" [%0], [%1], %2, [%3];\\n\" ::\"r\"(dst + f * kFieldBytes + r * kZT * 4),\n"
    "          \"l\"(src[f]), \"r\"(row), \"r\"(bar)\n"
    "          : \"memory\");\n"
    "  }\n"
)
# The two copies of a plane issued by thread 0 of warps 0 and 1, one each (a
# copy that lands before the expected bytes are set leaves the barrier's
# tx-count below zero until they are).
_ISSUERS = [
    (_TMA_ISSUE,
     "  const int w = threadIdx.x / 32;\n"
     "  if (w == 0) mbar_expect_tx(bar, kSlotBytes);\n"
     "  if (w == 0) tma_load(dst, map_a, bar, z0, oy, plane, 0);\n"
     "  if (w == 1) tma_load(dst + kFieldBytes, map_u, bar, z0, oy, plane, 0);\n"),
    ("  if (threadIdx.x == 0) {\n    for (; issued <= min(last, s0 + kSlots - 1); ++issued) {",
     "  if (threadIdx.x % 32 == 0 && threadIdx.x < 64) {\n"
     "    for (; issued <= min(last, s0 + kSlots - 1); ++issued) {"),
    ("    if (threadIdx.x == 0) {\n      for (; issued <= min(last, x - kHX + kSlots); ++issued) {",
     "    if (threadIdx.x % 32 == 0 && threadIdx.x < 64) {\n"
     "      for (; issued <= min(last, x - kHX + kSlots); ++issued) {"),
]
_UBOX = "constexpr int kUBox = 2;"
_WAIT = ("    for (const int need = min(x + kHX, p.nx - 1); landed <= need; ++landed) {\n"
         "      const int k = landed - s0;\n"
         "      mbar_wait(bars + 8 * (k % kSlots), (k / kSlots) & 1);\n"
         "    }\n")


def _poll(pollers, sync):
    return [(_WAIT, f"    if ({pollers})\n"
                    "      for (const int need = min(x + kHX, p.nx - 1); landed <= need; ++landed) {\n"
                    "        const int k = landed - s0;\n"
                    "        mbar_wait(bars + 8 * (k % kSlots), (k / kSlots) & 1);\n"
                    "      }\n"
                    f"    {sync}();\n")]


_POLL_WARP = _poll("threadIdx.x % 32 == 0", "__syncwarp")
_POLL_CTA = _poll("threadIdx.x == 0", "__syncthreads")


def _geometry(zt, ahead):
    return [(_ZT, f"constexpr int kZT = {zt};"), (_AHEAD, f"constexpr int kAhead = {ahead};")]


# name -> (z extent of a column, planes in flight, CTAs an SM the plan is
# cut for, substitutions).
VARIANTS = {
    **{f"zt{zt}_p{p}": (zt, p, 1, [] if (zt, p) == (32, 4) else _geometry(zt, p))
       for zt in (16, 32, 64) for p in (2, 4, 6)},
    "zt32_p7": (32, 7, 1, _geometry(32, 7)),
    "zt16_p10": (16, 10, 1, _geometry(16, 10)),
    "zt16_p4_2cta": (16, 4, 2, _geometry(16, 4)),
    "ubox1": (32, 4, 1, [(_UBOX, "constexpr int kUBox = 1;")]),
    "rows": (32, 4, 1, [(_TMA_ISSUE, _ROW_ISSUE)]),
    "issue2": (32, 4, 1, _ISSUERS),
    "poll_warp": (32, 4, 1, _POLL_WARP),
    "poll_cta": (32, 4, 1, _POLL_CTA),
}

def variant_source(name: str) -> str:
    """``csrc/dma_probe.cu`` with the variant's substitutions; each anchor
    must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name][3], name)


def _is_kernel(mangled: str):
    return _sweep.kernel_name(mangled) if "dma_probe_kernel" in mangled else None


def _build(name: str):
    lib, log = _sweep.build(variant_source(name), f"dma_probe_{name}", BUILD)
    return name, lib, _sweep.registers(log, _is_kernel)


def _us(call) -> float:
    return sum(_sweep.kernel_us(call, CALLS).values())


def _baddbmm(a, u):
    """One ``torch.baddbmm`` computing 2a + u₀ − u₁ (chip_smoke's yardstick)."""
    coef = torch.tensor([1.0, -1.0], device=a.device).view(1, 1, 2)
    return lambda: torch.baddbmm(a.view(1, 1, -1), coef, u.view(1, 2, -1), beta=2.0)


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("dma_probe_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    sms = dma_probe.sms_of(device)
    fields = {shape: dma_probe.inputs(shape, device) for shape in CHECKED + TIMED}
    rows = []
    for rep in range(REPEATS):
        for name, path, regs in built:
            zt, ahead, per_sm, _ = VARIANTS[name]
            lib = dma_probe.bind(ctypes.CDLL(str(path)))
            row = {"variant": name, "repeat": rep, "zt": zt, "ahead": ahead,
                   "slots": 2 * dma_probe.HX + 1 + ahead, "registers": regs}

            def plan(shape, zt=zt, ahead=ahead, per_sm=per_sm):
                return dma_probe.plan(shape, per_sm * sms, zt, ahead)

            def call(shape, lib=lib, plan=plan):
                a, u = fields[shape]
                chunks = plan(shape).chunks
                return lambda: dma_probe.launch(lib, a, u, chunks)

            try:
                for shape in CHECKED:
                    a, u = fields[shape]
                    err = float(torch.max(torch.abs(call(shape)() -
                                                    dma_probe.dma_probe_reference(a, u))))
                    if err != 0.0:
                        raise AssertionError(f"{name} at {shape}: max|Δ| {err} != 0")
            except RuntimeError as refused:  # the entry point's error code
                row["refused"] = str(refused)
            else:
                for shape in TIMED:
                    p = plan(shape)
                    us = _us(call(shape))
                    row[f"us_{shape[0]}"] = us
                    row[f"ctas_{shape[0]}"] = p.ctas
                    row[f"moved_tbs_{shape[0]}"] = p.moved_bytes / us / 1e6
            row["device"] = device_name(device)
            print(json.dumps(row), flush=True)
            rows.append(row)
        for shape in TIMED:
            a, u = fields[shape]
            row = {"variant": "yardsticks", "repeat": rep, "shape": list(shape),
                   "plain_us": _us(lambda: dma_probe.dma_probe_reference(a, u)),
                   "baddbmm_us": _us(_baddbmm(a, u)), "device": device_name(device)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
