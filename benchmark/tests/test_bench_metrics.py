"""Each metric reader on a small canned Chrome trace and window."""
import json

import pytest

from benchmark import flops, harness
from benchmark import trace as tr

STRETCH = {"ph": "X", "cat": "user_annotation", "name": tr.STRETCH, "ts": 1000.0, "dur": 1000.0}
EVENTS = [
    STRETCH,
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 1050.0,
     "dur": 20.0},
    {"ph": "X", "cat": "kernel", "name": "void jv_warp_kernel<1>(float const*, int*, int, int)",
     "ts": 1100.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 1200.0,
     "dur": 300.0},
    {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 2>",
     "ts": 1400.0, "dur": 300.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": tr.STRETCH, "ts": 1050.0, "dur": 700.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1750.0, "dur": 200.0},
    {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<4>", "ts": 3000.0,
     "dur": 50.0},
]


@pytest.fixture
def run(tmp_path):
    path = tmp_path / "canned.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    config = harness.load("configs", "sedt-urbansed")
    traffic = harness.load("traffic", "train-b256")
    window = {"window_s": 2.0, "steps": 20, "clips": 20 * 256, "intervals_ms": [90.0] * 18
              + [100.0, 200.0], "data_wait_s": 0.04, "data_waits": 20, "t0": 5.0}
    return {"config": config, "traffic": traffic, "window": window, "setup_s": 12.5,
            "trace": tr.load(str(path), steps=2)}


def read(name, run):
    return harness.read_metrics([{"name": name, "unit": "u"}], run).get(name, {}).get("value")


def test_bench_trace_keeps_the_stretch_and_device_events(run):
    t = run["trace"]
    assert t.window_s == pytest.approx(1e-3)
    assert len(t.device) == 4  # the annotation on the device and the late kernel left out
    assert tr.busy_s(t) == pytest.approx(20e-6 + 10e-6 + 500e-6)


@pytest.mark.parametrize("name, want", [
    ("setup_s", 12.5),
    ("clips_per_s", 20 * 256 / 2.0),
    ("step_ms_p90", 100.0 * 0.1 + 90.0 * 0.9 + 0.0),
    ("data_wait_ms", 2.0),
    ("device_idle_pct", 100.0 * (1 - 530e-6 / 1e-3)),
    ("launches_per_step", 1.5),
    ("elementwise_ms_per_step", 0.15),
    ("conv_ms_per_step", 0.15),
])
def test_bench_reader(run, name, want):
    assert read(name, run) == pytest.approx(want)


def test_bench_mfu_reader(run):
    work = flops.step_flops(run["config"], 256) * 20
    assert read("mfu", run) == pytest.approx(100 * work / (2.0 * 989e12))


def test_bench_k1_roofline_reader(run):
    least = flops.k1_bytes(run["config"], 256) / 3.35e12
    assert flops.k1_bytes(run["config"], 256) == 768 * 10 * 20 * 4 + 768 * 20 * 4
    assert read("k1_roofline", run) == pytest.approx(100 * least / 10e-6)


@pytest.mark.parametrize("name", ["device_idle_pct", "launches_per_step", "k1_roofline",
                                  "elementwise_ms_per_step", "conv_ms_per_step"])
def test_bench_trace_readers_return_nothing_without_a_trace(run, name):
    assert read(name, dict(run, trace=None)) is None


def test_bench_breakdown(run):
    b = tr.breakdown(run["trace"])
    assert b["device_ops"][0][0].startswith("sm90_xmma") and len(b["device_ops"]) == 4
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(300e-6)  # 1700 .. 2000 µs
    assert sum(gaps.values()) == pytest.approx(1e-3 - 530e-6)
