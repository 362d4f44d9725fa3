"""Where does the fused gradient kernel's time go, and what would move it?
Builds variants of ``csrc/fused_gradient.cu`` made by text substitutions
(a tuning constant changed, a launch bound, a part of the work removed),
checks each variant that keeps the results against the plain version, and
times each of its two kernels with ``torch.profiler`` at 128³ (config3's
energy with the 7-tap filter, and the data term alone) and the whole call at
256³ with CUDA events.

Variants that remove work (``timing_only``) compute wrong results on
purpose: they say what that work costs. Prints one JSON row per variant and
repeat, each naming the device.

    python -m levelsetfusion_tpu_torch.experiments.fused_gradient_sweep [variant ...]

GPU only: it builds with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments import _sweep
from levelsetfusion_tpu_torch.experiments._timing import device_name, resolve_device
from levelsetfusion_tpu_torch.ops.kernels import _lib
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient as fg

SOURCE = _lib.SOURCE_DIR / "fused_gradient.cu"
BUILD = _lib.BUILD_DIR / "fused_gradient_sweep"
SHAPE, BIG = (128, 128, 128), (256, 256, 256)
REPEATS = 2

_TERMS_LOAD = "    if (q < d.q_lo || q >= d.q_hi) return;\n    float* s = in_slot(q);"
_G_LOAD = ("      if (q >= q1 || !inside(q)) return;\n      float* s = g_slot(q);\n"
           "      const int64_t base")
_G_STORE = "    for (int k = 0; k < 3; ++k) g[k * d.n + v] = total[k];"
_U_STORE = "        new_u[k * d.n_out + v0 + e] = nu;"
_BOUNDS = "__global__ void __launch_bounds__(kThreads, 3)\n    terms_kernel("
_DERIVS = "        if (a_inner && d_inner[k])"
_TERMS = "      if (v_inner && inner(x + d.x_off, d.x_global))"
_CHUNK = "constexpr int kMinXChunk = 16;"

# name -> (substitutions, timing_only)
VARIANTS = {
    "base": ([], False),
    "no_staging": ([(_TERMS_LOAD, "    return;\n    float* s = in_slot(q);"),
                    (_G_LOAD, _G_LOAD.replace("return;", "return;\n      return;"))], True),
    "no_stores": ([(_G_STORE, "    if (total[0] == 1234.5f) g[v] = total[1];"),
                   (_U_STORE, "        if (nu == 1234.5f) new_u[v0] = nu;")], True),
    "edge_rules_everywhere": ([(_DERIVS, "        if (false)"),
                               (_TERMS, "      if (false)")], False),
    "terms_64_registers": ([(_BOUNDS, _BOUNDS.replace("(kThreads, 3)", "(kThreads, 4)"))], False),
    "terms_free_registers": ([(_BOUNDS, _BOUNDS.replace("(kThreads, 3)", "(kThreads)"))], False),
    "two_planes_ahead": ([("constexpr int kAhead = 1;", "constexpr int kAhead = 2;")], False),
    "min_chunk_8": ([(_CHUNK, _CHUNK.replace("16", "8"))], False),
    "min_chunk_32": ([(_CHUNK, _CHUNK.replace("16", "32"))], False),
    "min_chunk_64": ([(_CHUNK, _CHUNK.replace("16", "64"))], False),
}


def variant_source(name: str) -> str:
    """``csrc/fused_gradient.cu`` with the variant's substitutions; each
    anchor must occur exactly once."""
    return _sweep.substituted(SOURCE, VARIANTS[name][0], name)


def _kernel_key(mangled: str):
    if "terms_kernel" in mangled:
        return "terms_kernel"
    return "sobolev_update_kernel<3>" if "update_kernelILi3E" in mangled else None


def _build(name: str):
    """Compile a variant; returns its name, library and registers/spills
    per kernel."""
    lib, log = _sweep.build(variant_source(name), f"fused_gradient_{name}", BUILD)
    return name, lib, _sweep.registers(log, _kernel_key)


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.lsf_fused_partials_len.argtypes = list(fg.PARTIALS_ARGTYPES)
    lib.lsf_fused_partials_len.restype = ctypes.c_int64
    lib.lsf_fused_gradient_update.argtypes = list(fg.UPDATE_ARGTYPES)
    lib.lsf_fused_gradient_update.restype = ctypes.c_int
    lib.lsf_fused_error_string.argtypes = [ctypes.c_int]
    lib.lsf_fused_error_string.restype = ctypes.c_char_p
    return lib


def _inputs(shape, device):
    """TSDF-like fields and a warp, as chip_smoke.py builds them."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.4)
    warped = np.tanh(np.roll(base, 1, axis=0) * 0.4)
    warp = (rng.standard_normal((3,) + shape) * 0.8).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (canonical, warped, warp)]


def _call_us(call, n=20) -> float:
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main(device="cuda", names=None) -> list:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("fused_gradient_sweep builds CUDA variants: it needs the GPU")
    names = list(names or VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    kw = dict(w_data=1.0, w_smooth=0.2, w_ls=0.1, killing=True, gamma=0.1, band_union=True,
              taps=fg.sobolev_taps(7, 0.1))
    cases = {"full": kw, "data_only": {**kw, "w_smooth": 0.0, "w_ls": 0.0}}
    full, ragged, big = (_inputs(s, device) for s in (SHAPE, (37, 50, 61), BIG))
    rate = torch.tensor(0.5, device=device)
    wants = [(f, fg.fused_gradient_update_reference(f[1], f[0], f[2], rate, **kw))
             for f in (full, ragged)]
    library = fg._library
    rows = []
    try:
        for rep in range(REPEATS):
            for name, path, regs in built:
                lib = _bind(path)
                fg._library = lambda lib=lib: lib
                err = None
                if not VARIANTS[name][1]:
                    err = 0.0
                    for (c, w, u), (want_u, want_s) in wants:
                        got_u, got_s = fg.fused_gradient_update(w, c, u, rate, **kw)
                        err = max(err, float(torch.max(torch.abs(got_u - want_u))))
                        if not torch.allclose(got_s, want_s, rtol=1e-4, atol=0.0):
                            raise AssertionError(f"{name}: stats {got_s} != {want_s}")
                    if err > 2e-5 * (1 + float(torch.max(torch.abs(want_u)))):
                        raise AssertionError(f"{name}: warp max|Δ| {err:.3e}")
                c, w, u = full
                cb, wb, ub = big
                row = {"variant": name, "repeat": rep, "registers": regs, "max_abs_err": err,
                       **{f"us_{case}": _sweep.kernel_us(lambda k=k: fg.fused_gradient_update(
                           w, c, u, rate, **k)) for case, k in cases.items()},
                       "us_call_256": round(_call_us(lambda: fg.fused_gradient_update(
                           wb, cb, ub, rate, **kw), 10), 1),
                       "device": device_name(device)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        fg._library = library
    return rows


if __name__ == "__main__":
    main(names=sys.argv[1:] or None)
