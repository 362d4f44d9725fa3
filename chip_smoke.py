"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            (from the root of the repository)

Builds the CUDA kernels of the solve loop from ``levelsetfusion_tpu_torch/
csrc``, holds each against its plain torch version on the card, checks a
small kernel solve against the plain solve on the CPU, runs the config3
preset (128³, full energy) through ``cli.run_experiment`` on the card with
the kernels' launch counters reset just before, and times the solve and each
kernel against its plain version. Every phase prints one line and raises on
failure. The line before the last is a JSON object describing the kernels;
the last line is ``{"ok": true, "device": {...}}``. Without CUDA it fails
before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from levelsetfusion_tpu_torch.cli import _grid, _pair_3d, run_experiment
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
    for name in ("resample", "fused_gradient"):
        _lib.build(name)
    seconds = time.perf_counter() - t0
    regs = []
    for name in ("resample", "fused_gradient"):
        log = (_lib.BUILD_DIR / f"lib{name}.log").read_text()
        regs += [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"[1] build: {seconds:.1f} s; ptxas: {' | '.join(regs)}")


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


def main():
    phase0_card()
    phase1_build()
    err_resample = phase2_resample()
    err_fused = phase3_fused()
    phase4_solve_parity()
    launches = phase5_main_path()
    times = phase6_timing()
    kernels = [
        {"name": "warp_field_cm", "route": "cuda",
         "source": "levelsetfusion_tpu_torch/csrc/resample.cu",
         "replaces": "levelsetfusion_tpu/ops/pallas/resample.py:427",
         "launches": launches["resample"], "max_abs_err": err_resample,
         "ms": times["resample"][0], "plain_ms": times["resample"][1]},
        {"name": "fused_gradient_update", "route": "cuda",
         "source": "levelsetfusion_tpu_torch/csrc/fused_gradient.cu",
         "replaces": "levelsetfusion_tpu/ops/pallas/fused_gradient.py:1267",
         "launches": launches["fused_gradient"], "max_abs_err": err_fused,
         "ms": times["fused_gradient"][0], "plain_ms": times["fused_gradient"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
