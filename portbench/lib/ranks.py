"""Ranks of a cell on several chips: one process a rank, started with
torchrun's environment (``MASTER_ADDR``/``MASTER_PORT`` on a free localhost
port, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as
``chip_smoke.py::_ranks`` starts them; ``parallel/mesh.py::init_group``
joins through ``env://``. Each rank writes its results to a file; every
process is waited for, and killed if it outlives the deadline."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

RUN = Path(__file__).resolve().parents[1] / "run.py"
DEADLINE_S = 1150.0  # a first run in a checkout builds the kernels


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run(argv: List[str], world: int, t0_wall: float) -> List[dict]:
    """Run ``run.py argv`` as ``world`` ranks; their results, rank order."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                env = {**os.environ, "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port), "RANK": str(r), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(r)}
                cmd = [sys.executable, str(RUN), *argv, "--rank", str(r), "--world",
                       str(world), "--t0", repr(t0_wall), "--out", outs[r]]
                # A rank's standard output goes to standard error: the result
                # line is this process's alone.
                procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr.fileno()))
            for p in procs:
                p.wait(timeout=DEADLINE_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"a rank failed: exit codes {codes}")
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
    return results
