"""Every cell of BENCHMARK.json resolves to its files, and a cell whose
configuration and traffic exist needs nothing but its entry."""

import json
import shutil

import pytest

from portbench.lib import cells

BENCH = cells.benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    c = cells.cell(workload)
    assert hasattr(c.driver, "setup") and hasattr(c.driver, "window")
    assert hasattr(c.driver, "check") and hasattr(c.driver, "control")
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        if m["name"] != "setup_s":
            assert hasattr(cells.reader(m["name"]), "read"), m["name"]
    assert c.limits, f"limits/{workload}.json"


def test_every_metric_reported_with_the_metric_it_moves():
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
        for w in m["workloads"]:
            assert moved.get("workloads") is None or w in moved["workloads"], (m["name"], w)


def test_a_new_cell_needs_only_its_entry(tmp_path):
    """A checkout with one more workload entry (an existing configuration
    and traffic) and its limits file: the cell resolves."""
    shutil.copytree(cells.HERE, tmp_path / cells.HERE.name)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "config3-pairs8", "config": "config3_3d_full_energy",
                               "traffic": "blob_pairs8", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = tmp_path / cells.HERE.name / "limits"
    shutil.copy(limits / "config3-pairs.json", limits / "config3-pairs8.json")
    c = cells.cell("config3-pairs8", root=tmp_path)
    assert c.traffic["pool"] == 8 and c.config["driver"] == "pair_solve"
    assert c.limits == cells.cell("config3-pairs").limits
