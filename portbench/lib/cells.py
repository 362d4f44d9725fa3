"""Everything of a cell, found by the names in ``BENCHMARK.json``.

- a configuration: ``BENCHMARK.json``'s ``configs`` entry names its file
  (``configs/<name>.json``), whose ``driver`` key names the entry path;
- a traffic mix: ``traffic/<traffic>.json``, whose ``generator`` key names
  its generator, ``traffic/<generator>.py`` (``lib/traffic.py::generate``);
- an entry path: ``drivers/<driver>.py`` (``setup``, ``window``, ``check``);
- a metric: ``metrics/<name>.py``, or for a name ``<base>.<split>`` (one
  quantity split by the end-to-end metric it moves) ``metrics/<base>.py``;
  each has ``read(readings)``, which returns None where it finds nothing;
- the limits of the cell's comparison: ``limits/<workload>.json``.

So a new cell whose configuration and traffic exist needs only a
``BENCHMARK.json`` entry and its limits file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parents[1]  # the benchmark's directory
ROOT = HERE.parent  # the checkout


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    limits: Dict[str, float]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return metric.get("workloads") is None or workload in metric["workloads"]


def metric_path(name: str, root: Path = ROOT) -> Path:
    base = HERE.relative_to(ROOT)
    exact = root / base / "metrics" / f"{name}.py"
    return exact if exact.exists() else root / base / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str, root: Path = ROOT):
    return load_module(metric_path(name, root), f"portbench_metric_{name.replace('.', '_')}")


def cell(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = benchmark(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    base = root / HERE.relative_to(ROOT)
    with open(base / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    driver = importlib.import_module(f"portbench.drivers.{config['driver']}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in moved and _reports(m, workload)]
    limits_path = base / "limits" / f"{workload}.json"
    limits = {}
    if limits_path.exists():
        with open(limits_path) as f:
            limits = json.load(f)
    return Cell(workload, int(w["chips"]), config, traffic, driver, e2e, layer, limits)
