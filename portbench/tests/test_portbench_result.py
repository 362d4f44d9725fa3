"""The result line's schema and the judgement of the numbers compared."""

import json
import math

from portbench.lib import harness
from tiny import cell, run


def test_result_line_schema():
    line = run(cell("config3-pairs"))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in cell("config3-pairs").end_to_end}
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))


def test_traced_line_carries_per_layer_metrics_and_device_times():
    c = cell("config4-memory")
    line = run(c, trace=1)
    assert {"busy_s", "window_s"} <= set(line["device"])
    allowed = {m["name"] for m in c.per_layer}
    assert set(line["metrics"]) <= allowed and line["metrics"]
    assert list(line)[-1] == "checks"


def test_judge():
    ok, checks = harness.judge([("a", 0.5), ("b", 1.0)], {"a": 1.0, "b": 1.0})
    assert ok and checks["b"] == {"value": 1.0, "limit": 1.0}
    assert not harness.judge([("a", 2.0)], {"a": 1.0})[0]
    assert not harness.judge([("a", 0.0)], {})[0]  # no limit: not correct
    assert not harness.judge([("a", float("nan"))], {"a": 1.0})[0]
    assert not harness.judge([], {"a": 1.0})[0]  # nothing compared: not correct


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"levelsetfusion_tpu_torch": 1, "levelsetfusion_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({**mods, "jax.numpy": 1}) == ["jax"]
    assert harness.forbidden_modules({"levelsetfusion_tpu.cli": 1, "flax": 1}) == [
        "flax", "levelsetfusion_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "config3-pairs", "--seed", "1", "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
