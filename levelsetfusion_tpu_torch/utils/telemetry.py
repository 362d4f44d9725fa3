"""Telemetry. Twin of ``levelsetfusion_tpu/utils/telemetry.py``.

Per-iteration energy components (data / smoothing / level set) and
warp-update statistics (max / mean), written as CSV, events as JSONL and the
run summary as JSON, in the JAX package's schema so that runs of the two
packages diff line by line.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np


def _host(a) -> np.ndarray:
    """A telemetry buffer as a host array (one device copy per buffer)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def telemetry_to_rows(telemetry, iterations: int) -> List[Dict[str, float]]:
    """SolveTelemetry -> list of per-iteration dict rows."""
    data, smooth, ls, max_u, mean_u = (_host(t) for t in telemetry)
    rows = []
    for i in range(int(iterations)):
        rows.append(
            {
                "iteration": i,
                "data_energy": float(data[i]),
                "smoothing_energy": float(smooth[i]),
                "level_set_energy": float(ls[i]),
                "total_energy": float(data[i] + smooth[i] + ls[i]),
                "max_warp_update": float(max_u[i]),
                "mean_warp_update": float(mean_u[i]),
            }
        )
    return rows


class RunLogger:
    """Writes per-iteration telemetry (CSV), events (JSONL) and summary (JSON)
    into a run directory; optionally echoes to stderr."""

    FIELDS = [
        "level",
        "frame",
        "iteration",
        "data_energy",
        "smoothing_energy",
        "level_set_energy",
        "total_energy",
        "max_warp_update",
        "mean_warp_update",
    ]

    def __init__(self, out_dir: str, verbose: bool = False):
        self.out_dir = out_dir
        self.verbose = verbose
        os.makedirs(out_dir, exist_ok=True)
        self._csv_file = open(os.path.join(out_dir, "telemetry.csv"), "w", newline="")
        self._csv = csv.DictWriter(self._csv_file, fieldnames=self.FIELDS)
        self._csv.writeheader()
        self._events = open(os.path.join(out_dir, "events.jsonl"), "w")
        self.summary: Dict[str, Any] = {}
        self._start = time.perf_counter()

    def log_solve(self, result, level: int = 0, frame: int = 0) -> None:
        """Log a SolveResult's full telemetry."""
        for row in telemetry_to_rows(result.telemetry, result.iterations):
            row = {"level": level, "frame": frame, **row}
            self._csv.writerow(row)
            if self.verbose:
                print(
                    f"[f{frame} l{level} i{row['iteration']:03d}] "
                    f"E_data={row['data_energy']:.4f} "
                    f"E_smooth={row['smoothing_energy']:.4f} "
                    f"E_ls={row['level_set_energy']:.4f} "
                    f"max|du|={row['max_warp_update']:.5f}",
                    file=sys.stderr,
                )
        self._csv_file.flush()
        self.event(
            "solve_done",
            level=level,
            frame=frame,
            iterations=int(result.iterations),
            converged=bool(result.converged),
        )

    def event(self, kind: str, **kw) -> None:
        self._events.write(json.dumps({"event": kind, **kw}) + "\n")
        self._events.flush()

    def focus_voxel(self, name: str, coords, **fields) -> None:
        """The focus-coordinate deep dive: every logged quantity at one
        voxel, as an event (and echoed when verbose). A field is a scalar
        (the CLI reads the values on the device and passes scalars) or a
        whole field, indexed here."""
        def _at(v):
            a = _host(v)
            return float(a) if a.ndim == 0 else float(a[tuple(coords)])

        vals = {k: _at(v) for k, v in fields.items()}
        self.event("focus_voxel", name=name, coords=list(coords), **vals)
        if self.verbose:
            print(f"[focus {name} @{coords}] {vals}", file=sys.stderr)

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def finish(self, **summary) -> Dict[str, Any]:
        self.summary.update(summary)
        self.summary.setdefault(
            "wall_seconds", round(time.perf_counter() - self._start, 3)
        )
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=2, default=_json_default)
        self._csv_file.close()
        self._events.close()
        return self.summary


def _json_default(o):
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "value"):  # enums
        return o.value
    return str(o)
