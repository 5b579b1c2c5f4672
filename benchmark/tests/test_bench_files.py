"""Every part of the benchmark is a file found by its name, and
``BENCHMARK.json`` names only parts that exist."""
import importlib
import json
import re

import pytest

from benchmark import harness

BENCH = harness.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_files_load(cell):
    w = harness.load("workloads", cell)
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert (w["config"], w["traffic"], w["chips"]) == (entry["config"], entry["traffic"],
                                                       entry["chips"])
    config = harness.load("configs", w["config"])
    traffic = harness.load("traffic", w["traffic"])
    assert config["name"] == w["config"] and traffic["batch"] > 0
    assert config["train_clips"] // traffic["batch"] >= traffic["check_steps"]
    mod = importlib.import_module(f"benchmark.entries.{w['entry']}")
    assert callable(mod.run) and callable(mod.check)
    assert set(w["limits"]) <= {"out_gap", "grad_gap", "grad_median", "grad_median_ratio",
                                "change_gap"}
    assert {"grad_gap", "change_gap"} <= set(w["limits"])


@pytest.mark.parametrize("name", METRICS)
def test_bench_metric_reader_loads(name):
    assert callable(importlib.import_module(f"benchmark.metrics.{name}").read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_bench_config_entry_matches_file(config):
    with open(harness.ROOT / config["file"]) as f:
        data = json.load(f)
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert config["file"].startswith(BENCH["paths"][0] + "/")


def test_bench_names_and_limits():
    for thing in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(thing["name"]), thing["name"]
    assert len(set(CELLS)) == len(CELLS) and len(set(METRICS)) == len(METRICS)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
    assert 1 <= BENCH["run_seconds"] <= 51
