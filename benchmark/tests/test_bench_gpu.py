"""On the card: each cell's run at its own size comes out correct with every
end-to-end metric, and the control at the cell's size fails the cell's
limits.  Run them on the card with

    python -m pytest benchmark/tests/test_bench_gpu.py -m gpu -q
"""
import time

import pytest
import torch

from benchmark import control, harness

CELLS = [w["name"] for w in harness.benchmark_file()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_is_correct_on_the_card(card, cell):
    result, lines = harness.run_cell(cell, 2 ** 32 + 17, 3.0, False, card, time.perf_counter())
    assert result["correct"] is True, lines
    want = {m["name"] for m in harness.metrics_of(cell, False, harness.benchmark_file())}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_fails_on_the_card(card, cell):
    w = harness.load("workloads", cell)
    config, traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
    got = control.readings(config, traffic, 5, card, "control")
    assert any(got[k]["value"] > limit for k, limit in w["limits"].items()), got
