"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics and the result line.

A cell on one chip runs in this process. A cell on several chips runs one
process a rank (``ranks.py``: torchrun's environment on a free localhost
port); every rank runs the same set-up, window and comparison, rank 0
decides when the window ends and computes the metrics, and each rank writes
what it measured to a file that this process reads and prints.

A driver (``drivers/<name>.py``) gives ``setup(run) -> state``,
``window(run, state) -> Record`` and ``check(run, state, record) ->
[(name, value), ...]``, the numbers compared with the reference, each
judged against ``limits/<workload>.json``: ``correct`` holds where every
number is at most its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

from portbench.lib import cells, ranks, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "levelsetfusion_tpu")


@dataclasses.dataclass
class Record:
    """What a window did, as its driver records it (rank 0's on several
    ranks). ``iterations[i]`` is request i's solver iterations (each a B2
    call and a B1 call), and each request adds ``b1_extra`` B1 calls (the
    final or the blend's resample)."""

    latencies_s: List[float]
    attempted: int
    failed: int
    window_s: float
    iterations: List[int]
    voxels: int  # of the whole volume
    dim: int
    b1_call_bytes: float  # one call on this rank
    b2_call_bytes: float
    b1_extra: int = 1
    io_wait_s: Optional[List[float]] = None


@dataclasses.dataclass
class Run:
    """What a driver is given."""

    cell: cells.Cell
    seed: int
    seconds: float
    device: object  # torch.device
    tracer: tracing.Tracer
    scratch: str  # a directory of this run's own under TMPDIR
    rank: int = 0
    world: int = 1


class Readings:
    """What a metric's ``read`` sees: the window's record, the traced
    stretch (None in an untraced run or where it saw no device event) and
    the chips used."""

    def __init__(self, record: Record, trace, chips: int):
        self.record, self.trace, self.chips = record, trace, chips

    def traced_calls(self) -> Dict[str, int]:
        """B1 and B2 calls of the requests inside the traced stretch."""
        t, r = self.trace, self.record
        its = r.iterations[t.first:t.stop]
        return {"b1": sum(its) + r.b1_extra * len(its), "b2": sum(its)}


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a cell on several chips (set by the parent process).
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def metric_values(cell: cells.Cell, readings: Readings, trace: bool,
                  setup_s: float) -> Dict[str, dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each as its reader gives it; a reader's None leaves the
    metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = setup_s if m["name"] == "setup_s" else cells.reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers, limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number at most its limit;
    a number without a limit, or not finite, is not correct."""
    checks, ok = {}, bool(numbers)
    for name, value in numbers:
        limit = limits.get(name)
        checks[name] = {"value": float(value), "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok, checks


def run_rank(cell: cells.Cell, args, rank: int, world: int, t0_wall: float,
             device=None) -> dict:
    """Set-up, window and comparison on this process's device (``cuda:rank``;
    the CPU tests pass the CPU, where the program runs its plain versions
    and the device numbers are 0)."""
    import torch

    device = torch.device("cuda", rank) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        tracer = tracing.Tracer(bool(args.trace), device_is_cuda=cuda)
        run = Run(cell, args.seed, args.seconds, device, tracer, scratch, rank, world)
        tracer.warm()
        state = cell.driver.setup(run)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.time() - t0_wall
        t_window = time.perf_counter()
        record = cell.driver.window(run, state)
        if cuda:
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        t_check = time.perf_counter()
        numbers = cell.driver.check(run, state, record)
        t_end = time.perf_counter()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    trace = tracer.finish()
    print(f"portbench: rank {rank}: set-up {setup_s:.3f} s, window {t_check - t_window:.3f} s, "
          f"comparison {t_end - t_check:.3f} s, trace reduction "
          f"{time.perf_counter() - t_end:.3f} s", file=sys.stderr)
    out = {
        "rank": rank,
        "setup_s": setup_s,
        "peak": peak,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "numbers": numbers,
        "attempted": record.attempted,
        "failed": record.failed,
        "busy_s": trace.busy_s if trace else 0.0,
        "span_s": trace.span_s if trace else 0.0,
        "forbidden": forbidden_modules(),
    }
    if rank == 0:
        readings = Readings(record, trace, world)
        out["metrics"] = metric_values(cell, readings, bool(args.trace), setup_s)
        if trace:
            out["breakdown"] = {"device_ops": [list(x) for x in trace.device_ops],
                                "idle_gaps": [list(x) for x in trace.idle_gaps]}
    return out


def result_line(cell: cells.Cell, results: List[dict], trace: bool) -> dict:
    """The contract's last line from every rank's results (rank 0's
    metrics; the peak of the fullest chip; busy seconds averaged over the
    chips)."""
    head = results[0]
    correct, checks = judge(head["numbers"], cell.limits)
    device = {"platform": "gpu", "kind": head["kind"], "count": len(results),
              "memory_peak_bytes": max(r["peak"] for r in results)}
    line = {"correct": correct, "attempted": head["attempted"], "failed": head["failed"],
            "metrics": head["metrics"], "device": device}
    if trace:
        device["busy_s"] = sum(r["busy_s"] for r in results) / len(results)
        device["window_s"] = head["span_s"]
        if "breakdown" in head:
            line["breakdown"] = head["breakdown"]
    line["checks"] = checks
    return line


def _rank_main(args) -> int:
    """A rank of a cell on several chips: run, write the results file."""
    cell = cells.cell(args.workload)
    result = run_rank(cell, args, args.rank, args.world, args.t0)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


def main(argv, t0_wall: float) -> int:
    args = parse(argv)
    if args.rank is not None:
        return _rank_main(args)
    cell = cells.cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"this process sees {have}", file=sys.stderr)
        return 3
    if cell.chips == 1:
        results = [run_rank(cell, args, 0, 1, t0_wall)]
    else:
        results = ranks.run(argv, cell.chips, t0_wall)
    bad = sorted({m for r in results for m in r["forbidden"]} | set(forbidden_modules()))
    if bad:
        print(f"portbench: modules that the run may not load are loaded: {bad}",
              file=sys.stderr)
        return 4
    line = result_line(cell, results, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
