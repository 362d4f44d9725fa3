"""The multi-device dry run of the sharded machinery. Twin of
``__graft_entry__.py::dryrun_multichip``, on ``torch.distributed``:

    python -m levelsetfusion_tpu_torch.dryrun                    (a world of 1)
    torchrun --nproc-per-node N -m levelsetfusion_tpu_torch.dryrun
    python -m levelsetfusion_tpu_torch.dryrun --device cpu       (gloo)

On a world of N (NCCL on CUDA, gloo on the CPU) and JAX's shapes, solver
settings and tolerances:

- ``solve_single_level_sharded`` of a (8 N, 16, 128) in-band pair, 2
  iterations of Killing + level set + Sobolev, live halo 8; then the fusion
  step, ``warp_field_sharded`` and ``blend``: 2 iterations, a finite
  canonical, and the gathered warp within 1e-5 of the single-device solve;
- the Schur solver (T = 4) on the sphere pair and the single-device solve,
  both to the gate tau = 2e-3: both converge, and their warps lie within
  max(30 tau, 0.05 max |u_ref|);
- where N is even, the 2D mesh (2, N / 2): the 2D sync solver within 1e-5
  of the single-device solve, and Schur-2D converged within the same gap;
  otherwise the line says it was skipped, as JAX's does;
- ``solve_hierarchical_sharded`` over 2 levels: a finite warp, 2 level
  results and 2 level halos.

Every rank runs the sharded solves and the gathers; rank 0 runs the
single-device references, checks, and prints the one summary line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.fusion import blend, init_state
from levelsetfusion_tpu_torch.models.params import HierarchicalParams, SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.models.single_level import solve_single_level
from levelsetfusion_tpu_torch.parallel import (
    close_group,
    init_group,
    make_mesh_2d,
    solve_hierarchical_sharded,
    solve_single_level_schur,
    solve_single_level_schur2d,
    solve_single_level_sharded,
    solve_single_level_sharded2d,
    warp_field_sharded,
)
from levelsetfusion_tpu_torch.parallel.mesh import gather_field, shard_field

TAU = 2e-3  # the Schur certifications' common gate
PARAMS = SolverParams(
    max_iterations=2,
    learning_rate=0.3,
    smoothing_term_weight=0.1,
    smoothing_mode=SmoothingMode.KILLING,
    level_set_term_weight=0.1,
    sobolev_smoothing=True,
    convergence_threshold=0.0,
)
CONVERGED = PARAMS.replace(max_iterations=400, convergence_threshold=TAU)


def sphere_fields_3d(shape, offset=0.6):
    """Smooth sphere-SDF pair with a sub-voxel offset along x: a
    well-conditioned case the solvers drive to convergence quickly."""
    axes = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    c = [s / 2.0 for s in shape]
    r = min(shape) / 3.0
    d1 = np.sqrt(sum((a - cc) ** 2 for a, cc in zip(axes, c)))
    d2 = np.sqrt(sum((a - cc - o) ** 2 for a, cc, o in zip(axes, c, [offset, 0.0, 0.0])))
    return tuple(np.clip((d - r) / 3.0, -1, 1).astype(np.float32) for d in (d1, d2))


def tiny_fields_3d(shape):
    """Deterministic in-band canonical/live TSDF pair of the given shape."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(shape).astype(np.float32)
    return np.tanh(base * 0.3), np.tanh(np.roll(base, 1, axis=0) * 0.3)


def _check(ok, message) -> None:
    if not ok:
        raise AssertionError(message)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def dryrun_multichip(group) -> str | None:
    """The dry run on ``group`` (see the module docstring); rank 0 returns
    the summary line, the other ranks None. Raises AssertionError on rank 0
    when a check fails."""
    n, device = group.world, group.device
    shape = (8 * n, 16, 128)
    canonical, live = (torch.from_numpy(a).to(device) for a in tiny_fields_3d(shape))
    sphere_c, sphere_l = (torch.from_numpy(a).to(device) for a in sphere_fields_3d(shape))

    # Sharded warp solve (halo exchanges, reductions), then the fusion step.
    canon_blk, live_blk = shard_field(canonical, group), shard_field(live, group)
    result = solve_single_level_sharded(canon_blk, live_blk, PARAMS, group=group,
                                        live_halo=8)
    state = blend(init_state(canon_blk), warp_field_sharded(live_blk, result.warp, group, 8))
    fused_ok = bool(gather_field(torch.isfinite(state.canonical).all().view(1).float(),
                                 group).all())
    warp = gather_field(result.warp, group)
    schur = solve_single_level_schur(shard_field(sphere_c, group), shard_field(sphere_l, group),
                                     CONVERGED, group=group, live_halo=8, inner_iterations=4)
    schur_warp = gather_field(schur.warp.contiguous(), group)
    mesh2d = None
    if n % 2 == 0:
        mesh2d = make_mesh_2d(group, (2, n // 2))
        res2d = solve_single_level_sharded2d(shard_field(canonical, mesh2d),
                                             shard_field(live, mesh2d), PARAMS, mesh=mesh2d,
                                             live_halo=8)
        warp2d = gather_field(res2d.warp.contiguous(), mesh2d)
        s2d = solve_single_level_schur2d(shard_field(sphere_c, mesh2d),
                                         shard_field(sphere_l, mesh2d), CONVERGED, mesh=mesh2d,
                                         live_halo=8, inner_iterations=4)
        s2d_warp = gather_field(s2d.warp.contiguous(), mesh2d)
    hres = solve_hierarchical_sharded(canonical, live, HierarchicalParams(levels=2, base=PARAMS),
                                      group=group, min_live_halo=8)
    if group.rank != 0:
        return None

    it = result.iterations
    _check(it == 2, it)
    _check(fused_ok, "the fused canonical is not finite")
    ref = solve_single_level(canonical, live, PARAMS)
    err = _max_diff(warp, ref.warp)
    _check(err < 1e-5, f"sharded-vs-single warp mismatch: {err}")
    ref_conv = solve_single_level(sphere_c, sphere_l, CONVERGED)
    _check(schur.converged, "schur did not reach its gate")
    _check(ref_conv.converged, "reference did not reach its gate")
    _check(bool(torch.isfinite(schur_warp).all()), "the schur warp is not finite")
    scale = max(float(torch.max(torch.abs(ref_conv.warp))), 1e-6)
    gap_limit = max(30 * TAU, 0.05 * scale)
    schur_gap = _max_diff(schur_warp, ref_conv.warp)
    _check(schur_gap < gap_limit, (schur_gap, scale))
    if mesh2d is not None:
        err2d = _max_diff(warp2d, ref.warp)
        _check(err2d < 1e-5, f"2D-mesh-vs-single warp mismatch: {err2d}")
        _check(s2d.converged, "schur2d did not reach its gate")
        gap2d = _max_diff(s2d_warp, ref_conv.warp)
        _check(gap2d < gap_limit, (gap2d, scale))
        mesh_line = (f"2D mesh (2,{n // 2}) parity max|Δ|={err2d:.2e}; schur2d (2,{n // 2}) "
                     f"{s2d.outer_steps} outers, threshold-matched gap {gap2d:.2e}; ")
    else:
        mesh_line = f"2D mesh skipped (n_devices={n}); "
    _check(bool(torch.isfinite(hres.warp).all()), "the hierarchical warp is not finite")
    _check(len(hres.level_results) == 2 and len(hres.level_halos or ()) == 2,
           f"hierarchical: {len(hres.level_results)} level results, halos {hres.level_halos}")
    return (f"dryrun_multichip ok: {n} devices, shape {shape}, {it} sharded solver "
            f"iterations (B1 + B2 per block), warp parity vs single-device max|Δ|={err:.2e}; "
            f"schur {schur.outer_steps} outers, threshold-matched gap {schur_gap:.2e} at "
            f"tau={TAU:g}; {mesh_line}hierarchical-sharded level halos {list(hres.level_halos)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL; the default, fails without CUDA) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available "
                           "(pass --device cpu for gloo)")
    group = init_group(args.device)
    try:
        line = dryrun_multichip(group)
    finally:
        close_group(group)
    if line is not None:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
