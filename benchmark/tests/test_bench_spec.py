"""Every name in BENCHMARK.json finds its files, and the result line
keeps the contract's keys."""
import importlib
import os

import pytest

from benchmark import harness
from benchmark.tests import _small

SPEC = _small.SPEC


def test_every_config_loads_by_name():
    for c in SPEC["configs"]:
        cfg = harness.load_json(_small.ROOT, c["file"])
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in ("source", "assumed", "guarantees", "score_precision"):
            assert key in cfg


def test_every_mix_and_limit_loads_by_name():
    for w in SPEC["workloads"]:
        mix = harness.load_json(harness.HERE, "traffic",
                                f"{w['traffic']}.json")
        driver = importlib.import_module(
            f"benchmark.drivers.{mix['entry']}")
        assert callable(driver.run)
        limits = harness.load_json(harness.HERE, "limits",
                                   f"{w['name']}.json")
        assert limits and all(v >= 0 for v in limits.values())
        assert w["chips"] == 1


def test_every_metric_has_a_reader_or_an_end_to_end_value():
    for m in SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for w in m["workloads"]:
            e2e = next(e for e in SPEC["end_to_end"]
                       if e["name"] == m["moves"])
            assert harness.applies(e2e, w)
    assert any(e["name"] == "setup_s" for e in SPEC["end_to_end"])


def test_paths_hold_only_the_benchmark():
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert os.path.exists(os.path.join(_small.ROOT, "benchmark", "run.py"))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(trace):
    r = _small.run("c2-stream", trace=trace, seconds=0.5)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    names = set(r["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert names <= {m["name"] for m in SPEC["per_layer"]}
        assert {"pack_ms.stream", "wave_ms.stream"} <= names
    else:
        assert names == {"placements_per_s", "setup_s"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
