"""The plain reference agrees with the port on the CPU at a tiny size: a
whole run of each cell's harness with the port in float32, whose check
steps the reference follows to round-off."""
import pytest

from benchmark import harness
from benchmark.tests import tiny

CELLS = ["sedt-urbansed.train-b256", "spsedt-dcase.pretrain-b200"]


@pytest.mark.parametrize("cell", CELLS)
def test_bench_reference_follows_the_port_in_f32(cell):
    result, lines = tiny.run(cell, f32=True)
    # float32 on both sides: what is left is the order of sums on the CPU;
    # the ratio is that over bf16's round-off, about 1e-3
    bound = {"out_gap": 1e-4, "grad_gap": 1e-4, "grad_median": 1e-5, "grad_median_ratio": 0.05,
             "change_gap": 1e-3}
    assert {"grad_gap", "change_gap"} <= set(result["checks"])
    for name, check in result["checks"].items():
        assert check["value"] < bound[name], lines
    assert result["correct"] is True
    want = {m["name"] for m in harness.metrics_of(cell, False, harness.benchmark_file())}
    assert set(result["metrics"]) == want and {"setup_s", "clips_per_s"} <= want


def test_bench_traced_run_reports_per_layer_metrics():
    result, _ = tiny.run("sedt-urbansed.train-b256", traced=True, f32=True)
    # on the CPU there is no device: only the host's readings are there
    assert {"mfu", "data_wait_ms"} <= set(result["metrics"])
    assert "device_idle_pct" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"
