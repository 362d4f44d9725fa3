"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            (from the root of the repository)

Builds every CUDA kernel of the port from ``levelsetfusion_tpu_torch/csrc``
(one nvcc per source, all at once), holds each against its plain torch
version on the card, checks a small kernel solve against the plain solve on
the CPU, runs the config3 preset (128³, full energy) through
``cli.run_experiment`` on the card with the kernels' launch counters reset
just before, and times the solve and each kernel against its plain version.
Then it drives the port's experiment entry points (``levelsetfusion_tpu_torch.
experiments``: mxu_conv, fused_io_probe, dma_probe, fused_ablation,
fused_gradient_bench, resample_variants, v10_xslab), each with its kernels'
launch counters reset just before and read just after, and holds their
kernels against their plain versions. Every phase prints at least one line and raises on failure. The line before the last is a JSON object describing the kernels;
the last line is ``{"ok": true, "device": {...}}``. Without CUDA it fails
before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from levelsetfusion_tpu_torch.cli import _grid, _pair_3d, run_experiment
from levelsetfusion_tpu_torch.experiments import (
    dma_probe,
    fused_ablation,
    fused_gradient_bench,
    fused_io_probe,
    mxu_conv,
    resample_variants,
    v10_xslab,
)
from levelsetfusion_tpu_torch.experiments._timing import best_ms
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.ops.kernels import _lib, fused_gradient, resample
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    fused_gradient_update_reference,
    sobolev_taps,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import (
    warp_field_cm,
    warp_field_cm_reference,
)
from levelsetfusion_tpu_torch.utils.config import PRESETS

PRESET = "config3_3d_full_energy"
FULL = (128, 128, 128)
RAGGED = (37, 50, 61)
# tests/test_fused_gradient.py CASES: (w_smooth, w_ls, killing, sobolev, band_union)
CASES = [
    (0.2, 0.0, False, False, True),
    (0.2, 0.1, True, False, True),
    (0.1, 0.1, True, True, True),
    (0.2, 0.1, False, True, False),
    (0.0, 0.0, False, False, True),
]
BENCH_ITERS = 300  # bench.py's N_ITER
LIBRARIES = ("resample", "fused_gradient", "conv_yz", "fused_io_probe", "dma_probe",
             "resample_variants", "v10_xslab")
RAGGED_X = (20, 64, 128)  # a ragged x for the resample variants (their Z is 128)
B45_VARIANTS = ("vf_fori", "vf_chunk", "vf_unroll", "v7_chunk", "v7_unroll")


def _fields(shape, seed, warp_scale):
    """TSDF-like canonical and warped fields and a (3, *shape) warp, as the
    JAX package's fused-gradient tests build them."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.4)
    warped = np.tanh(np.roll(base, 1, axis=0) * 0.4)
    warp = (rng.standard_normal((3,) + shape) * warp_scale).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (canonical, warped, warp)]


def _close(name, got, want, rtol, atol=0.0):
    err = torch.abs(got.double() - want.double())
    bound = atol + rtol * torch.abs(want.double())
    if not bool(torch.all(err <= bound)):
        worst = float(torch.max(err - bound))
        raise AssertionError(f"{name}: exceeds rtol={rtol} atol={atol} by {worst:.3e}")
    return float(torch.max(err)) if err.numel() else 0.0


def _time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase0_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(line)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    return line


def phase1_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_lib.build, LIBRARIES))
    seconds = time.perf_counter() - t0
    regs = []
    for name in ("resample", "fused_gradient"):
        log = (_lib.BUILD_DIR / f"lib{name}.log").read_text()
        regs += [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"[1] build of {len(LIBRARIES)} libraries: {seconds:.1f} s; ptxas: {' | '.join(regs)}")


def phase2_resample():
    worst = 0.0
    for shape, seed in ((FULL, 1), (RAGGED, 2)):
        rng = np.random.default_rng(seed)
        live = torch.from_numpy(
            np.tanh(rng.standard_normal(shape).astype(np.float32))
        ).cuda()
        # |u| up to 6 voxels: many corners read outside the volume.
        warp = torch.from_numpy(
            rng.uniform(-6.0, 6.0, (3,) + shape).astype(np.float32)
        ).cuda()
        got = warp_field_cm(live, warp)
        torch.cuda.synchronize()
        want = warp_field_cm_reference(live, warp)
        err = float(torch.max(torch.abs(got - want)))
        if not err <= 1e-5:
            raise AssertionError(f"resample {shape}: max|Δ| {err:.3e} > 1e-5")
        worst = max(worst, err)
    print(f"[2] resample vs plain at {FULL} and {RAGGED}: max|Δ| {worst:.3e} (tol 1e-5)")
    return worst


def phase3_fused():
    worst = 0.0
    for shape, seed in ((FULL, 3), (RAGGED, 4)):
        canonical, warped, warp = _fields(shape, seed, 0.8)
        rate = torch.tensor(0.3, device="cuda")
        for w_smooth, w_ls, killing, sob, band in CASES:
            kw = dict(w_data=1.0, w_smooth=w_smooth, w_ls=w_ls, killing=killing,
                      gamma=0.1, band_union=band,
                      taps=sobolev_taps(7, 0.1) if sob else ())
            got_w, got_s = fused_gradient_update(warped, canonical, warp, rate, **kw)
            torch.cuda.synchronize()
            want_w, want_s = fused_gradient_update_reference(
                warped, canonical, warp, rate, **kw
            )
            case = f"fused {shape} case {(w_smooth, w_ls, killing, sob, band)}"
            worst = max(worst, _close(case + " warp", got_w, want_w, 2e-5, 2e-5))
            _close(case + " sums", got_s[:4], want_s[:4], 1e-4)
            _close(case + " maxes", got_s[4:], want_s[4:], 1e-5)
    print(f"[3] fused gradient vs plain, 5 cases at {FULL} and {RAGGED}: "
          f"warp max|Δ| {worst:.3e} (rtol/atol 2e-5; sums rtol 1e-4, maxes rtol 1e-5)")
    return worst


def phase4_solve_parity():
    cfg = PRESETS[PRESET]
    small = dataclasses.replace(cfg, grid_shape=(32, 32, 64), grid_offset=(-16, -16, 70))
    params = cfg.solver.replace(max_iterations=30, convergence_threshold=0.0)
    canonical, live = _pair_3d(small, _grid(small), torch.device("cpu"))
    ref = solve_single_level(canonical, live, params)
    got = solve_single_level(canonical.cuda(), live.cuda(), params)
    if got.iterations != ref.iterations:
        raise AssertionError(f"iterations {got.iterations} != {ref.iterations}")
    err = _close("solve warp", got.warp.cpu(), ref.warp, 3e-4, 3e-6)
    for name, a, b in zip(ref.telemetry._fields, got.telemetry, ref.telemetry):
        _close(f"telemetry {name}", a.cpu(), b, 2e-4, 1e-8)
    print(f"[4] kernel solve (cuda) vs plain solve (cpu) at (32, 32, 64), "
          f"{got.iterations} iterations: warp max|Δ| {err:.3e} "
          f"(rtol 3e-4 atol 3e-6; telemetry rtol 2e-4)")


def phase5_main_path():
    with tempfile.TemporaryDirectory() as out:
        resample.launch_count = 0
        fused_gradient.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = run_experiment(PRESETS[PRESET], out, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"resample": resample.launch_count,
                    "fused_gradient": fused_gradient.launch_count}
    it = summary["iterations"]
    print(f"[5] {PRESET} at {FULL} on cuda: iterations {it}, converged "
          f"{summary['converged']}, residual {summary['residual_before']:.6f} -> "
          f"{summary['residual_after']:.6f} (reduction "
          f"{summary['residual_reduction']:.4f}), max|u| "
          f"{summary['max_abs_displacement']}, wall {wall:.2f} s, launches {launches}")
    numbers = [summary["residual_before"], summary["residual_after"],
               summary["final_data_energy"], *summary["max_abs_displacement"]]
    if not all(np.isfinite(numbers)):
        raise AssertionError(f"non-finite results: {numbers}")
    if not summary["converged"]:
        raise AssertionError("config3 did not converge")
    if not summary["residual_reduction"] >= 2.0:
        raise AssertionError("config3 residual reduction < 2")
    if launches["fused_gradient"] != it or launches["resample"] != it + 1:
        raise AssertionError(f"launch counts {launches} for {it} iterations")
    return launches


def phase6_timing():
    # bench.py's headline inputs: in-band random fields from seed 0.
    rng = np.random.default_rng(0)
    base = rng.standard_normal(FULL).astype(np.float32)
    canonical = torch.from_numpy(np.tanh(base * 0.3)).cuda()
    live = torch.from_numpy(np.tanh(np.roll(base, 1, axis=0) * 0.3)).cuda()
    params = PRESETS[PRESET].solver.replace(
        max_iterations=BENCH_ITERS, convergence_threshold=0.0
    )
    solve_single_level(canonical, live, params.replace(max_iterations=5))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    solve_single_level(canonical, live, params)
    end.record()
    torch.cuda.synchronize()
    solve_ms = start.elapsed_time(end)
    rate = float(np.prod(FULL)) * BENCH_ITERS / (solve_ms / 1e3)

    warp = torch.from_numpy(
        rng.uniform(-2.0, 2.0, (3,) + FULL).astype(np.float32)
    ).cuda()
    lr = torch.tensor(0.5, device="cuda")
    p = params
    kw = dict(w_data=p.data_term_weight, w_smooth=p.smoothing_term_weight,
              w_ls=p.level_set_term_weight, killing=True,
              gamma=p.rigidity_enforcement_factor, band_union=p.band_union_only,
              taps=sobolev_taps(p.sobolev_kernel_size, p.sobolev_strength))
    warped = warp_field_cm(live, warp)
    # Plain, kernel, kernel, plain: compare within one call, in turns.
    r_plain = [_time_ms(lambda: warp_field_cm_reference(live, warp), 10)]
    r_kern = [_time_ms(lambda: warp_field_cm(live, warp), 100) for _ in range(2)]
    r_plain.append(_time_ms(lambda: warp_field_cm_reference(live, warp), 10))
    f_plain = [_time_ms(lambda: fused_gradient_update_reference(
        warped, canonical, warp, lr, **kw), 5)]
    f_kern = [_time_ms(lambda: fused_gradient_update(
        warped, canonical, warp, lr, **kw), 50) for _ in range(2)]
    f_plain.append(_time_ms(lambda: fused_gradient_update_reference(
        warped, canonical, warp, lr, **kw), 5))
    times = {
        "resample": (min(r_kern), min(r_plain)),
        "fused_gradient": (min(f_kern), min(f_plain)),
    }
    per_iter = solve_ms / BENCH_ITERS
    print(f"[6] solve at {FULL}, {BENCH_ITERS} iterations, threshold 0: "
          f"{solve_ms:.1f} ms, {per_iter * 1e3:.1f} us/iter, {rate:.4e} voxel*iter/s; "
          f"resample {times['resample'][0] * 1e3:.1f} us (plain "
          f"{times['resample'][1] * 1e3:.1f} us); fused gradient "
          f"{times['fused_gradient'][0] * 1e3:.1f} us (plain "
          f"{times['fused_gradient'][1] * 1e3:.1f} us); runs kernel "
          f"{[round(t * 1e3, 1) for t in r_kern + f_kern]} us, plain "
          f"{[round(t * 1e3, 1) for t in r_plain + f_plain]} us")
    return times


def _kernel_name(mangled):
    """``name<template ints>`` of a kernel in an anonymous namespace, from
    its mangled name (``_ZN<len><namespace><len><name>I...E...``)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name, tail = rest[m.end():m.end() + int(m.group(1))], rest[m.end() + int(m.group(1)):]
    args = re.findall(r"L[ib](\d+)E", tail.split("EEv")[0]) if tail.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


def phase7_ptxas():
    """Registers and spills of every experiment kernel instantiation (built in
    phase 1), from each library's ``nvcc -Xptxas -v`` log."""
    parts = []
    for name in LIBRARIES[2:]:
        log = (_lib.BUILD_DIR / f"lib{name}.log").read_text()
        kernels = []
        for entry in log.split("Compiling entry function '")[1:]:
            short = _kernel_name(entry.split("'", 1)[0])
            regs = re.search(r"Used (\d+) registers", entry)
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry))
            kernels.append(f"{short} {regs.group(1) if regs else '?'}r/{spill}B")
        parts.append(f"{name}: {', '.join(kernels)}")
    print(f"[7] ptxas, registers r / spill bytes B (window_kernel<loop, body, tents_once> "
          f"as codes of resample_variants.LOOPS and BODIES): {'; '.join(parts)}")


def phase8_mxu_conv():
    mxu_conv.launch_counts.update(dict.fromkeys(mxu_conv.launch_counts, 0))
    runs = [mxu_conv.run(shape=shape, reps=1024, device="cuda")
            for shape in ((16, 128, 128), FULL)]
    launches = dict(mxu_conv.launch_counts)
    if min(launches.values()) == 0:
        raise AssertionError(f"mxu_conv.run left a kernel unlaunched: {launches}")
    worst = {"stencil": 0.0, "banded_f32": 0.0, "banded_bf16": 0.0}
    off_bf16 = 0.0
    for shape in ((16, 128, 128), (5, 48, 80)):
        a, taps, cy, cz = mxu_conv.inputs(shape, "cuda")
        for reps in (1, 3):
            plain = mxu_conv.conv_yz_stencil_reference(a, taps, reps)
            for key, got in (("stencil", mxu_conv.conv_yz_stencil(a, taps, reps)),
                             ("banded_f32", mxu_conv.conv_yz_banded_f32(a, cy, cz, reps))):
                worst[key] = max(worst[key], _close(
                    f"conv_yz {key} {shape} reps {reps}", got, plain, 0.0, 1e-5))
            # The kernel and the plain version sum each intermediate in another
            # order, so where it lies within a float32 rounding of a bf16
            # rounding boundary the two round it to neighbouring bf16 values
            # (a step of <= 2^-7 relative). Hence 1e-4 on all but 0.1% of the
            # values, and 1e-2 (outputs are O(1)) on every value.
            got = mxu_conv.conv_yz_banded_bf16(a, cy, cz, reps)
            err = torch.abs(got - mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, reps))
            off = float(torch.mean((err > 1e-4).float()))
            if off > 1e-3 or float(torch.max(err)) > 1e-2:
                raise AssertionError(f"conv_yz banded_bf16 {shape} reps {reps}: max|Δ| "
                                     f"{float(torch.max(err)):.3e}, {off:.2e} over 1e-4")
            worst["banded_bf16"] = max(worst["banded_bf16"], float(torch.max(err)))
            off_bf16 = max(off_bf16, off)
    a, taps, cy, cz = mxu_conv.inputs(FULL, "cuda")
    plain_ms = {
        "stencil": best_ms(lambda: mxu_conv.conv_yz_stencil_reference(a, taps, 1), a.device, 3),
        "banded_f32": best_ms(lambda: mxu_conv.conv_yz_banded_reference(a, cy, cz, 1),
                              a.device, 3),
        "banded_bf16": best_ms(lambda: mxu_conv.conv_yz_banded_bf16_reference(a, cy, cz, 1),
                               a.device, 3),
    }
    full = runs[1]
    ms = {"stencil": full["stencil_us_per_convpass"] / 1e3,
          "banded_f32": full["tc_f32_us_per_convpass"] / 1e3,
          "banded_bf16": full["tc_bf16_us_per_convpass"] / 1e3}
    print(f"[8] conv_yz vs plain at (16, 128, 128) and (5, 48, 80), reps 1 and 3: "
          f"max|Δ| {worst} (stencil, tc_f32 1e-5 vs plain stencil; tc_bf16 vs its "
          f"bf16 plain: 1e-4 on all but {off_bf16:.2e} of values, 1e-2 on all); "
          f"per conv pass at {FULL}: kernel ms {ms}, plain ms {plain_ms}; "
          f"launches {launches}")
    return {key: (launches[key], worst[key], ms[key], plain_ms[key]) for key in worst}


def phase9_fused_io():
    fused_io_probe.launch_count = 0
    rows = fused_io_probe.main(device="cuda")
    launches = fused_io_probe.launch_count
    if launches == 0:
        raise AssertionError("fused_io_probe.main launched no kernel")
    we, ce, ue = fused_io_probe.pad(*fused_io_probe.inputs(FULL, "cuda"))
    worst = 0.0
    for body, rtol, atol in (("copy", 0.0, 0.0), ("arith", 0.0, 1e-6), ("rolls", 1e-5, 0.0)):
        want = fused_io_probe.fused_io_probe_reference(we, ce, ue, body)
        for xb in fused_io_probe.XBS:
            got = fused_io_probe.fused_io_probe(we, ce, ue, body, xb)
            worst = max(worst, _close(f"fused_io_probe {body} xb {xb}", got, want, rtol, atol))
    plain_ms = best_ms(lambda: fused_io_probe.fused_io_probe_reference(we, ce, ue, "rolls"),
                       we.device, 3)
    rolls = next(r for r in rows if r["body"] == "rolls" and r["xb"] == 16)
    print(f"[9] fused_io_probe vs plain at {FULL}, 3 bodies x xb {fused_io_probe.XBS}: "
          f"max|Δ| {worst:.3e} (copy exact, arith 1e-6, rolls rtol 1e-5); rolls xb 16 "
          f"{rolls['ms'] * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us); launches {launches}")
    return launches, worst, rolls["ms"], plain_ms


def phase10_dma():
    dma_probe.launch_count = 0
    out = dma_probe.main(device="cuda")
    launches = dma_probe.launch_count
    if launches == 0:
        raise AssertionError("dma_probe.main launched no kernel")
    for shape in (dma_probe.SHAPE, FULL):
        a, u = dma_probe.inputs(shape, "cuda")
        err = float(torch.max(torch.abs(dma_probe.run(a, u) - dma_probe.dma_probe_reference(a, u))))
        if err != 0.0:
            raise AssertionError(f"dma_probe {shape}: max|Δ| {err} != 0")
    plain_ms = best_ms(lambda: dma_probe.dma_probe_reference(a, u), a.device, 20)
    print(f"[10] dma_probe exact at {dma_probe.SHAPE} and {FULL}; at {FULL} "
          f"{out['ms'] * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us), useful "
          f"{out['useful_gbs']:.1f} GB/s, moved {out['moved_gbs']:.1f} GB/s; "
          f"launches {launches}")
    return launches, 0.0, out["ms"], plain_ms


def phase11_b2_entry_points():
    fused_gradient.launch_count = 0
    ablation = fused_ablation.main(device="cuda")
    bench = fused_gradient_bench.main(device="cuda")
    launches = fused_gradient.launch_count
    if launches == 0:
        raise AssertionError("the B2 entry points launched no fused gradient kernel")
    numbers = [*ablation["ms_per_kernel_call"].values(), *bench["ms"].values(),
               bench["plain_step_ms"]]
    if not all(np.isfinite(numbers)) or min(numbers) <= 0:
        raise AssertionError(f"B2 entry points: bad times {numbers}")
    print(f"[11] fused_ablation and fused_gradient_bench at {FULL}: full "
          f"{bench['ms']['full(+sobolev)'] * 1e3:.1f} us per call vs plain step "
          f"{bench['plain_step_ms'] * 1e3:.1f} us ({bench['full_speedup_vs_plain']:.2f}x); "
          f"launches {launches}")


def phase12_resample_variants():
    t0 = time.perf_counter()
    rv = resample_variants
    names = (*rv.KERNELS, *B45_VARIANTS)
    rv.launch_counts.update(dict.fromkeys(rv.launch_counts, 0))
    rows = rv.main(device="cuda", names=names)
    launches = dict(rv.launch_counts)
    if min(launches.values()) == 0:
        raise AssertionError(f"resample_variants.main left a kernel unlaunched: {launches}")
    err = dict.fromkeys(names, 0.0)
    for shape in (FULL, RAGGED_X):
        field, warp = rv.inputs(shape, "cuda")
        for name in names:
            got = rv.variant_call(name)(field, warp)
            want = rv.resample_variant_reference(field, warp, name)
            err[name] = max(err[name], _close(f"{name} {shape}", got, want, 0.0, 1e-5))
    field, warp = rv.inputs(FULL, "cuda")
    warp_cm = rv.clamp_warp(warp).movedim(-1, 0).contiguous()
    b1 = warp_field_cm(field, warp_cm)
    vs_b1 = max(_close(f"{name} vs B1", rv.variant_call(name)(field, warp), b1, 0.0, 1e-5)
                for name in names if name not in rv.TIMING_ONLY)
    plain_ms = {name: best_ms(lambda: rv.resample_variant_reference(field, warp, name),
                              field.device, 3) for name in names}
    b1_ms = best_ms(lambda: warp_field_cm(field, warp_cm), field.device, 20)
    ms = {r["variant"]: r["us_per_call"] / 1e3 for r in rows}
    table = ", ".join(f"{name} {ms[name] * 1e3:.1f} ({plain_ms[name] * 1e3:.0f})"
                      for name in names)
    print(f"[12] resample variants vs plain at {FULL} and {RAGGED_X}: max|Δ| "
          f"{max(err.values()):.3e}, value-preserving vs B1 {vs_b1:.3e} (tol 1e-5); "
          f"us per call at {FULL}, kernel (plain): {table}; B1 {b1_ms * 1e3:.1f}; "
          f"launches {launches}; {time.perf_counter() - t0:.1f} s")

    def numbers(entry, name, group):
        return (launches[entry], max(err[v] for v in group), ms[name], plain_ms[name])

    return {"run_variant": numbers("run_variant", "v6", rv.KERNELS),
            "run_vmemfull": numbers("run_vmemfull", "vf_fori", B45_VARIANTS[:3]),
            "run_v7": numbers("run_v7", "v7_chunk", B45_VARIANTS[3:])}


def phase13_v10():
    t0 = time.perf_counter()
    v10_xslab.launch_count = 0
    rows = v10_xslab.main(device="cuda")
    launches = v10_xslab.launch_count
    if launches == 0:
        raise AssertionError("v10_xslab.main launched no kernel")
    field, warps = v10_xslab.inputs(FULL, "cuda")
    worst = 0.0
    for tag, _, warp in warps:
        want = v10_xslab.run_v10_reference(field, warp)
        for xb in v10_xslab.XBS:
            got = v10_xslab.run_v10(field, warp, xb)
            worst = max(worst, _close(f"v10 {tag} xb {xb}", got, want, 0.0, 1e-5))
    rfield, rwarp = resample_variants.inputs(RAGGED_X, "cuda")
    worst = max(worst, _close(f"v10 {RAGGED_X} xb 4", v10_xslab.run_v10(
        rfield, rwarp, 4, 64, 20), v10_xslab.run_v10_reference(rfield, rwarp), 0.0, 1e-5))
    random = warps[0][2]
    plain_ms = best_ms(lambda: v10_xslab.run_v10_reference(field, random), field.device, 3)
    table = ", ".join(f"{r['warp']} xb {r['xb']} {r['ms_per_call'] * 1e3:.1f}" for r in rows)
    print(f"[13] v10 vs plain at {FULL} (both warps, xb {v10_xslab.XBS}) and {RAGGED_X}: "
          f"max|Δ| {worst:.3e} (tol 1e-5); us per call: {table}; plain "
          f"{plain_ms * 1e3:.0f}; launches {launches}; {time.perf_counter() - t0:.1f} s")
    xb8 = next(r for r in rows if r["warp"] == "random" and r["xb"] == 8)
    return launches, worst, xb8["ms_per_call"], plain_ms


def _row(name, source, replaces, numbers):
    launches, err, ms, plain_ms = numbers
    return {"name": name, "route": "cuda",
            "source": f"levelsetfusion_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main():
    phase0_card()
    phase1_build()
    err_resample = phase2_resample()
    err_fused = phase3_fused()
    phase4_solve_parity()
    launches = phase5_main_path()
    times = phase6_timing()
    phase7_ptxas()
    conv = phase8_mxu_conv()
    io = phase9_fused_io()
    dma = phase10_dma()
    phase11_b2_entry_points()
    variants = phase12_resample_variants()
    v10 = phase13_v10()
    kernels = [
        _row("warp_field_cm", "resample.cu",
             "levelsetfusion_tpu/ops/pallas/resample.py:427",
             (launches["resample"], err_resample, *times["resample"])),
        _row("fused_gradient_update", "fused_gradient.cu",
             "levelsetfusion_tpu/ops/pallas/fused_gradient.py:1267",
             (launches["fused_gradient"], err_fused, *times["fused_gradient"])),
        _row("conv_yz_stencil", "conv_yz.cu", "experiments/mxu_conv.py:117",
             conv["stencil"]),
        _row("conv_yz_banded_f32", "conv_yz.cu", "experiments/mxu_conv.py:122",
             conv["banded_f32"]),
        _row("conv_yz_banded_bf16", "conv_yz.cu", "experiments/mxu_conv.py:149",
             conv["banded_bf16"]),
        _row("fused_io_probe", "fused_io_probe.cu", "experiments/fused_io_probe.py:71", io),
        _row("dma_probe", "dma_probe.cu", "experiments/dma_probe.py:145", dma),
        _row("run_variant", "resample_variants.cu", "experiments/resample_variants.py:197",
             variants["run_variant"]),
        _row("run_vmemfull", "resample_variants.cu", "experiments/resample_variants.py:280",
             variants["run_vmemfull"]),
        _row("run_v7", "resample_variants.cu", "experiments/resample_variants.py:348",
             variants["run_v7"]),
        _row("run_v10", "v10_xslab.cu", "experiments/v10_xslab.py:88", v10),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
