"""Cells shrunk to a size the CPU runs in seconds, for the tests: the same
files, a small grid around the wall and few iterations."""

import time

from portbench.lib import cells, harness


def cell(workload: str, iterations: int = 10, **config):
    c = cells.cell(workload)
    cfg = dict(c.config, grid_shape=[24, 24, 24], grid_offset=[-12, -12, 88])
    cfg["solver"] = dict(cfg["solver"],
                         max_iterations=min(cfg["solver"]["max_iterations"], iterations))
    cfg.update(config)
    return c._replace(config=cfg)


def run(c, seed: int = 2147483701, seconds: float = 0.5, trace: int = 0, **kw) -> dict:
    """One run of the shrunk cell on the CPU: its result line."""
    args = harness.parse(["--workload", c.name, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)])
    res = harness.run_rank(c, args, kw.pop("rank", 0), kw.pop("world", 1), time.time(),
                           device="cpu")
    return harness.result_line(c, [res], bool(trace))
