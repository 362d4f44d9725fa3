"""On the card: each one-chip cell runs end to end through ``run.py`` for a
short window and comes out correct (``python -m pytest portbench/tests -m
card`` on a machine with an NVIDIA GPU)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["config3-pairs", "config4-disk", "config4-memory"])
def test_cell_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "4294967311",
         "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
