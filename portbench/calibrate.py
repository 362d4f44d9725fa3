"""Readings that a cell's limits are set from (``limits/<workload>.json``),
on the card:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        [--program <seed> ...] [--fault <name>] [--control <seed> ...]

``--program``: for each seed a whole run of the cell (set-up, a window of
``--seconds``, the comparison), in this process on one chip or as the
cell's ranks, one JSON line each: the numbers compared and the end-to-end
metrics. ``--fault`` plants one of ``lib/faults.py``'s faults in every rank
of a cell on several chips for those runs. ``--control``: for each seed the driver's ``control``, the plain
reference in bfloat16 in the program's place (on one device), judged as the
program is, one JSON line each. The benchmark's own runs never run the
control.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.lib import cells, faults, harness, ranks, tracing  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.FAULTS, default="none")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    if args.fault != "none" and cell.chips == 1:
        ap.error("--fault is for a cell on several chips")
    import torch

    for seed in args.program:
        run_args = ["--workload", args.workload, "--seed", str(seed), "--seconds",
                    str(args.seconds), "--trace", "0"]
        t0 = time.time()
        if cell.chips == 1:
            results = [harness.run_rank(cell, harness.parse(run_args), 0, 1, t0)]
        elif args.fault != "none":
            results = faults.run_ranks(functools.partial(cells.cell, args.workload), run_args,
                                       cell.chips, args.fault)
        else:
            results = ranks.run(run_args, cell.chips, t0)
        line = harness.result_line(cell, results, False)
        print(json.dumps({"kind": "program", "fault": args.fault, "seed": seed,
                          "checks": line["checks"],
                          "metrics": line["metrics"], "correct": line["correct"]}), flush=True)
    for seed in args.control:
        with tempfile.TemporaryDirectory(prefix="portbench-") as scratch:
            run = harness.Run(cell, seed, args.seconds, torch.device("cuda", 0),
                              tracing.Tracer(False), scratch)
            numbers = cell.driver.control(run)
        _, checks = harness.judge(numbers, cell.limits)
        print(json.dumps({"kind": "control", "seed": seed, "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
