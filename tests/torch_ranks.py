"""Runs a function on N gloo ranks, one spawned process each, for the
parity tests of the port's sharded solvers (tests/test_torch_halo.py,
tests/test_torch_parallel.py, tests/test_torch_parallel2d.py,
tests/test_torch_schur.py, tests/test_torch_distributed_smoke.py).

The ranks meet on a ``FileStore`` under the test's ``tmp_path`` (no TCP
port, so xdist workers never collide). The test process computes the JAX
side and hands numpy arrays to the ranks; each rank runs every case it is
given, in one spawn, and writes its results with ``torch.save``. Every join
has a deadline, so a hang fails the test instead of eating the run's time.
This module imports torch and the port only: a rank never imports JAX.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import time
import traceback

import torch

JOIN_SECONDS = 240


def _rank_main(target, rank, world, store, args, out):
    """A spawned rank: join the group, run ``target(group, args)``, save
    its result (or the traceback) to ``out``."""
    torch.set_num_threads(1)
    from levelsetfusion_tpu_torch.parallel.mesh import close_group, init_group

    group = init_group("cpu", store_path=store, rank=rank, world=world, timeout_s=180)
    try:
        module, name = target.rsplit(".", 1)
        result = getattr(importlib.import_module(module), name)(group, args)
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        close_group(group)


def run_ranks(target: str, world: int, tmp_path, args=None, seconds: float = JOIN_SECONDS):
    """``[rank 0's result, ..., rank world-1's]`` of ``target(group, args)``
    (``"module.function"``, importable without JAX) on ``world`` gloo
    ranks."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"store_{target.rsplit('.', 1)[1]}_{world}")
    outs = [str(tmp_path / f"rank{r}_{os.getpid()}_{time.monotonic_ns()}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, store, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + seconds
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r, out in enumerate(outs):
        got = torch.load(out, weights_only=False) if os.path.exists(out) else {}
        if "error" in got:
            raise AssertionError(f"rank {r} of {world} failed:\n{got['error']}")
        if hung or "result" not in got:
            raise AssertionError(f"{target}: ranks {hung} hung past {seconds} s, "
                                 f"exit codes {[p.exitcode for p in procs]}")
        results.append(got["result"])
    return results


# --- rank-side cases ---------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def halo_cases(group, fields):
    """tests/test_halo.py's sharded computations on this rank's block of
    each field, plus the exchange's other fill, axis and pending forms and
    the reductions: ``{case: block output}``."""
    from levelsetfusion_tpu_torch.parallel import halo
    from levelsetfusion_tpu_torch.parallel.mesh import shard_field

    ramp, rnd, kernel = (torch.from_numpy(fields[k]) for k in ("ramp", "rnd", "kernel"))
    ramp, rnd = shard_field(ramp, group), shard_field(rnd, group)
    ext2 = halo.halo_exchange(rnd, 2, group, fill="replicate")
    g = halo.d_edge_fixed(ext2, 2, group)
    pending = halo.halo_exchange(rnd, 3, group, fill="zero", wait=False)
    return {
        "replicate_left": _np(halo.halo_exchange(ramp, 2, group, fill="replicate")[:4]),
        "truncation_right": _np(halo.halo_exchange(ramp, 1, group, fill="truncation")[-2:]),
        "d_edge_fixed": _np(g[1:-1]),
        "d_edge_fixed_twice": _np(halo.d_edge_fixed(g, 1, group)),
        "second_diff": _np(halo.second_diff(halo.halo_exchange(rnd, 1, group))),
        "convolve_zero_edges": _np(halo.convolve_zero_edges(rnd, kernel, group)),
        "zero_pending": _np(pending.wait()),
        "axis1": _np(halo.halo_exchange(rnd.T.contiguous(), 2, group, fill="truncation",
                                        axis=1)),
        "psum": _np(halo.psum_axis(rnd.sum().view(1), group)),
        "pmax": _np(halo.pmax_axis(rnd.max().view(1), group)),
    }


def _fusion(group, frames, camera, config, live_halo):
    """The sharded fusion's gathered state and final warp, and its reports."""
    from levelsetfusion_tpu_torch.models.fusion import fuse_sequence_sharded
    from levelsetfusion_tpu_torch.parallel.mesh import gather_field

    res = fuse_sequence_sharded(frames, camera, config, group=group, live_halo=live_halo)
    return res, [_np(gather_field(t, group)) for t in (*res.state, res.final_warp)]


def solve_cases(group, args):
    """Each case ``(canonical, live, params, live_halo)`` of ``args["solves"]``
    (full numpy fields) through the port's sharded solver on this rank's
    blocks, and ``args["fusion"]`` (or None) through the sharded fusion:
    ``{"solves": [(warp block, iterations, converged, telemetry, max|u|),
    ...], "fusion": (state, reports)}``."""
    from levelsetfusion_tpu_torch.parallel import solve_single_level_sharded
    from levelsetfusion_tpu_torch.parallel.mesh import shard_field

    out = []
    for canonical, live, params, live_halo in args["solves"]:
        res = solve_single_level_sharded(
            shard_field(torch.from_numpy(canonical), group),
            shard_field(torch.from_numpy(live), group), params, group=group,
            live_halo=live_halo)
        out.append((_np(res.warp), res.iterations, res.converged,
                    [_np(t) for t in res.telemetry], _np(res.max_abs_displacement)))
    fusion = None
    if args["fusion"] is not None:
        res, state = _fusion(group, *args["fusion"])
        fusion = (state, [r._asdict() for r in res.reports])
    return {"solves": out, "fusion": fusion}


def fusion_cases(group, args):
    """The sharded fusion (its gathered state and reports), a sharded
    checkpoint's round trip, the CLI's ``multi_frame_sharded_3d`` run and
    the JAX-written sharded checkpoint read as this rank's blocks."""
    from levelsetfusion_tpu_torch.cli import run_experiment
    from levelsetfusion_tpu_torch.utils import checkpoint

    res, state = _fusion(group, *args["fusion"])
    root = args["ckpt_root"]
    checkpoint.save(root, 5, res.state, res.final_warp, {"config": "c5"}, group=group)
    full = checkpoint.load(root, 5)
    mine = checkpoint.load(root, 5, group=group)
    summary = run_experiment(args["cli_config"], args["cli_out"], device="cpu")
    jax_blocks = checkpoint.load(args["jax_ckpt"], group=group)
    return {
        "state": state,
        "reports": [r._asdict() for r in res.reports],
        "ckpt_full": [_np(t) for t in (*full[0], full[1])],
        "ckpt_mine": [_np(t) for t in (*mine[0], mine[1])],
        "ckpt_blocks": [_np(t) for t in (*res.state, res.final_warp)],
        "ckpt_meta": full[2],
        "cli": summary,
        "jax_blocks": [_np(t) for t in (*jax_blocks[0], jax_blocks[1])],
    }


# --- the 2D-mesh, Schur and hierarchical sharded solvers ----------------------


def _solve_case(mesh, payload):
    """One of the sharded solvers (``payload["solver"]``: ``"sharded"``,
    ``"sharded2d"``, ``"schur"`` or ``"schur2d"``) on this rank's blocks of
    the full fields:
    ``(gathered warp, iterations, converged, telemetry, max|u|)``."""
    from levelsetfusion_tpu_torch import parallel
    from levelsetfusion_tpu_torch.parallel.mesh import gather_field, shard_field

    from levelsetfusion_tpu_torch.parallel.mesh import Mesh2D

    solver = getattr(parallel, f"solve_single_level_{payload['solver']}")
    where = {"mesh": mesh} if isinstance(mesh, Mesh2D) else {"group": mesh}
    res = solver(shard_field(torch.from_numpy(payload["canonical"]), mesh),
                 shard_field(torch.from_numpy(payload["live"]), mesh), payload["params"],
                 **where, **payload.get("kw", {}))
    return (_np(gather_field(res.warp.contiguous(), mesh)), res.iterations, res.converged,
            [_np(t) for t in res.telemetry], _np(res.max_abs_displacement))


def _warp2d_case(mesh, payload):
    """``warp_field_sharded2d`` on this rank's blocks, gathered."""
    from levelsetfusion_tpu_torch.parallel import warp_field_sharded2d
    from levelsetfusion_tpu_torch.parallel.mesh import gather_field, shard_field

    live, warp = (shard_field(torch.from_numpy(payload[k]), mesh) for k in ("live", "warp"))
    return _np(gather_field(warp_field_sharded2d(live, warp, mesh, payload["live_halo"]),
                            mesh))


def _hierarchical_case(mesh, payload):
    """``solve_hierarchical_sharded`` on the whole fields: ``(warp,
    per-level iterations, level halos, per-level data energies)``."""
    from levelsetfusion_tpu_torch.parallel import solve_hierarchical_sharded

    warm = payload.get("initial_warp")
    res = solve_hierarchical_sharded(
        torch.from_numpy(payload["canonical"]), torch.from_numpy(payload["live"]),
        payload["params"], group=mesh, **payload.get("kw", {}),
        initial_warp=None if warm is None else torch.from_numpy(warm))
    return (_np(res.warp), [r.iterations for r in res.level_results], res.level_halos,
            [_np(r.telemetry.data_energy) for r in res.level_results])


def _fusion_case(mesh, payload):
    """The sharded fusion on the 1D group or the 2D mesh: its gathered
    state and final warp, and its reports."""
    from levelsetfusion_tpu_torch.models.fusion import fuse_sequence_sharded
    from levelsetfusion_tpu_torch.parallel.mesh import Mesh2D, gather_field

    frames, camera, config, live_halo = payload
    res = fuse_sequence_sharded(frames, camera, config, group=mesh, live_halo=live_halo,
                                mesh_axes=("x", "y") if isinstance(mesh, Mesh2D) else None)
    return ([_np(gather_field(t.contiguous(), mesh)) for t in (*res.state, res.final_warp)],
            [r._asdict() for r in res.reports])


def _cli_case(mesh, payload):
    """A CLI run on this process group (the config's ``mesh_shape``, if
    any, the caller's): its summary."""
    from levelsetfusion_tpu_torch.cli import run_experiment

    cfg, out = payload
    return run_experiment(cfg, out, device="cpu")


def _checkpoint_case(mesh, payload):
    """A checkpoint of this rank's blocks of ``payload``'s three arrays
    written on the mesh, then read whole and as this rank's blocks."""
    from levelsetfusion_tpu_torch.models.fusion import FusionState
    from levelsetfusion_tpu_torch.parallel.mesh import shard_field
    from levelsetfusion_tpu_torch.utils import checkpoint

    root, arrays = payload
    blocks = [shard_field(torch.from_numpy(a), mesh) for a in arrays]
    checkpoint.save(root, 2, FusionState(*blocks[:2]), blocks[2], {"config": "mesh"},
                    group=mesh)
    full, mine = checkpoint.load(root, 2), checkpoint.load(root, 2, group=mesh)
    return ([_np(t) for t in (*full[0], full[1])], [_np(t) for t in (*mine[0], mine[1])],
            [_np(t) for t in blocks], full[2])


def _reduce_case(mesh, payload):
    """The reductions along each mesh axis and over both, of this rank's
    global rank, and the two-axis exchange of a ramp's block."""
    from levelsetfusion_tpu_torch.parallel import halo
    from levelsetfusion_tpu_torch.parallel.mesh import shard_field

    r = torch.tensor([float(mesh.rank)])
    block = shard_field(torch.from_numpy(payload["field"]), mesh)
    return ({name: [_np(fn(r, g)) for g in (*mesh.axes, mesh)]
             for name, fn in (("sum", halo.psum_axis), ("max", halo.pmax_axis))},
            _np(halo.exchange_2d(block, payload["width"], mesh, fill=payload["fill"])),
            (mesh.axes[0].index, mesh.axes[1].index))


def _psum_case(mesh, payload):
    """A sum over the group of a block of ``payload`` times (rank + 1)."""
    from levelsetfusion_tpu_torch.parallel.halo import psum_axis

    return float(psum_axis(torch.full(payload, float(mesh.rank + 1)), mesh).sum())


def _comm_case(mesh, payload):
    """``_solve_case`` with ``dist.batch_isend_irecv`` and ``dist.all_reduce``
    wrapped to count what this rank sends: ``({"bytes": isend bytes,
    "rounds": batches, "reductions": all_reduce calls}, iterations)``."""
    import torch.distributed as dist

    counts = {"bytes": 0, "rounds": 0, "reductions": 0}
    batch, all_reduce = dist.batch_isend_irecv, dist.all_reduce

    def counting_batch(ops):
        counts["rounds"] += 1
        counts["bytes"] += sum(op.tensor.numel() * op.tensor.element_size()
                               for op in ops if op.op is dist.isend)
        return batch(ops)

    def counting_reduce(tensor, *args, **kw):
        counts["reductions"] += 1
        return all_reduce(tensor, *args, **kw)

    dist.batch_isend_irecv, dist.all_reduce = counting_batch, counting_reduce
    try:
        iterations = _solve_case(mesh, payload)[1]
    finally:
        dist.batch_isend_irecv, dist.all_reduce = batch, all_reduce
    return counts, iterations


_CASES = {"solve": _solve_case, "comm": _comm_case, "psum": _psum_case, "warp2d": _warp2d_case,
          "hierarchical": _hierarchical_case, "fusion": _fusion_case, "cli": _cli_case,
          "checkpoint": _checkpoint_case, "reduce": _reduce_case}


def mesh_cases(group, args):
    """Each case ``(kind, payload)`` of ``args["cases"]`` on this rank, on
    the 1D group, or on the 2D mesh of shape ``args["mesh"]`` when given:
    the results in order."""
    from levelsetfusion_tpu_torch.parallel.mesh import make_mesh_2d

    mesh = make_mesh_2d(group, args["mesh"]) if args.get("mesh") else group
    return [_CASES[kind](mesh, payload) for kind, payload in args["cases"]]


def dryrun_case(group, args):
    """``levelsetfusion_tpu_torch.dryrun.dryrun_multichip`` on this rank:
    rank 0's summary line, None elsewhere."""
    from levelsetfusion_tpu_torch.dryrun import dryrun_multichip

    return dryrun_multichip(group)


def halo_bytes_cases(group, args):
    """Each exchange of ``args["cases"]`` (``(shape, width, axis, wait)``)
    on a seeded block under ``torch.profiler``: the program's
    ``halo.bytes_sent`` count, the bytes of every tensor the exchange handed
    to ``isend`` (read at ``dist.batch_isend_irecv``) and the ``lsf.``
    spans recorded, by name."""
    import collections

    import torch.distributed as dist

    from levelsetfusion_tpu_torch.parallel import halo
    from levelsetfusion_tpu_torch.utils import profiling

    handed = []
    real = dist.batch_isend_irecv

    def spy(ops):
        handed.append(sum(op.tensor.nbytes for op in ops if op.op is dist.isend))
        return real(ops)

    dist.batch_isend_irecv = spy
    out = []
    try:
        for shape, width, axis, wait in args["cases"]:
            x = torch.randn(shape, generator=torch.Generator().manual_seed(group.rank))
            handed.clear()
            with profiling.trace(args["log_dir"] + f"/rank{group.rank}") as prof:
                got = halo.halo_exchange(x, width, group, axis=axis, wait=wait)
                if not wait:
                    got.wait()
                halo.psum_axis(x.sum().view(1), group)
            names = collections.Counter(
                n for n in (e.name() for e in prof.profiler.kineto_results.events())
                if n.startswith("lsf."))
            out.append((profiling.counters().get("halo.bytes_sent", 0), sum(handed),
                        dict(names)))
    finally:
        dist.batch_isend_irecv = real
    return out
