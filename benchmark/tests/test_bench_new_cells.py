"""The audio-tag cell (``ast-audioset.tag-b64``) and the predict cell
(``sedt-urbansed.predict-b256``): whole runs of each at a tiny size on the
CPU (:mod:`benchmark.tests.tiny_cells`, the port in float32), their planted
faults and controls, their five readers on canned runs, the AST FLOP count
against ``torch.utils.flop_counter``, and, marked ``gpu``, each cell's run
and control at its own size on the card:

    python -m pytest benchmark/tests/test_bench_new_cells.py -m gpu -q
"""
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control_cells, flops_ast, harness
from benchmark import trace as tr
from benchmark.entries import tag_epoch
from benchmark.reference import ast as RA
from benchmark.reference.params import make_weights
from benchmark.tests import tiny_cells as TC
from benchmark.tests.test_bench_metrics import EVENTS
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.models import AST, ASTConfig
from sound_event_detection_transformer_tpu_torch.parallel.optim import make_ast_optimizer
from sound_event_detection_transformer_tpu_torch.utils import profiler

CELLS = [TC.TAG, TC.PREDICT]
ENTRY = {TC.TAG: "tag_epoch", TC.PREDICT: "predict"}
READERS = {TC.TAG: control_cells.tag_readings, TC.PREDICT: control_cells.predict_readings}


def read(name, run):
    return harness.read_metrics([{"name": name, "unit": "u"}], run).get(name, {}).get("value")


@pytest.mark.parametrize("cell", CELLS)
def test_bench_new_cell_is_correct_at_a_tiny_size(cell):
    result, lines = TC.run(cell)
    assert result["correct"] is True, lines
    assert set(result["checks"]) == set(harness.load("workloads", cell)["limits"])
    want = {m["name"] for m in harness.metrics_of(cell, False, harness.benchmark_file())}
    assert set(result["metrics"]) == want == {"clips_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


PREDICT_READERS = [{"name": n, "unit": "ms"} for n in ("copy_ms_per_batch", "decode_ms_per_batch")]


@pytest.mark.parametrize("cell, specs, host_metrics", [
    (TC.TAG, None, {"tag_mfu"}),
    (TC.PREDICT, PREDICT_READERS, {"copy_ms_per_batch", "decode_ms_per_batch"})])
def test_bench_new_cell_traced_run_reports_its_host_readings(cell, specs, host_metrics):
    """On the CPU there is no device: K4 never launches and no device range
    opens, so only the host's readings are there.  The predict cell is not
    in ``BENCHMARK.json``: its readers are named here."""
    result, _ = TC.run(cell, traced=True, specs=specs)
    assert set(result["metrics"]) == host_metrics
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in sorted(control_cells.FAULTS[ENTRY[c]])])
def test_bench_new_cell_fault_makes_the_run_not_correct(cell, fault):
    with control_cells.FAULTS[ENTRY[cell]][fault]():
        result, lines = TC.run(cell)
    assert result["correct"] is False, lines
    worst = max(float(c["value"]) / c["limit"] for c in result["checks"].values())
    assert worst > 10, lines


@pytest.mark.parametrize("cell", CELLS)
def test_bench_new_cell_control_fails_a_limit_and_the_program_none(cell):
    with TC.small(cell):
        got = dict(READERS[cell](TC.config(cell), TC.traffic(cell), 7, torch.device("cpu"),
                                 ["program", "control"]))
    limits = TC.workload(cell)["limits"]
    assert all(got["program"][k]["value"] <= v for k, v in limits.items()), got["program"]
    assert any(got["control"][k]["value"] > v for k, v in limits.items()), got["control"]


def test_bench_reference_ast_matches_the_port_at_a_tiny_size():
    m = dict(TC.tag_config()["model"])
    c = ASTConfig(**TC.AST_SMALL)
    model = AST(c)
    weights = make_weights(RA.param_spec(m), 3, torch.device("cpu"))
    model.load_state_dict(weights, strict=True)
    x = torch.randn(2, c.frames, c.n_mels, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = model(x), RA.forward(weights, x, m)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_bench_ast_flops_match_the_counter():
    """The analytic count of one f32 step at the tiny size and at batch 2
    equals the counter's on the port's own step (every product's forward and
    gradients, the patch convolution's weight gradient only)."""
    config = TC.tag_config()
    model = AST(ASTConfig(**TC.AST_SMALL))
    step = train_lib.make_audio_tag_step(model, make_ast_optimizer(model, 1e-5, 1))
    x, y = torch.randn(2, 96, 64, 1), torch.zeros(2, 12)
    with FlopCounterMode(display=False) as counter:
        step(x, y)
    assert flops_ast.step_flops(config, 2) == counter.get_total_flops()


def test_bench_ast_flops_at_the_cells_shape():
    config = harness.load("configs", "ast-audioset")
    assert flops_ast.tokens(config["model"]) == config["model"]["tokens"] == 1214
    assert flops_ast.step_flops(config, 1) / 1e9 == pytest.approx(782.61, abs=0.01)
    assert flops_ast.k4_shape(config, 64) == (64, 12, 1214, 64)
    assert flops_ast.k4_flops(config, 64) == 4 * 64 * 12 * 1214 ** 2 * 64
    assert flops_ast.k4_bytes(config, 64) == 4 * 64 * 12 * 1214 * 64 * 2
    # operations bound it: 0.293 ms against 0.142 ms of bytes
    assert flops_ast.k4_least_s(config, 64) == flops_ast.k4_flops(config, 64) / 989e12


@pytest.fixture
def tag_run():
    config = harness.load("configs", "ast-audioset")
    events = EVENTS + [{"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
                        "flash_mma_kernel<64, 4, 2>(__nv_bfloat16 const*)", "ts": 1600.0,
                        "dur": 20.0}]
    window = {"window_s": 2.0, "steps": 10, "clips": 640, "intervals_ms": [200.0] * 10,
              "data_wait_s": 0.0, "data_waits": 10, "t0": 5.0,
              "gpu_ranges_ms_per_step": {"attention.backward": 120.5}}
    return {"config": config, "traffic": harness.load("traffic", "tag-b64"), "window": window,
            "setup_s": 1.0, "trace": tr.from_events(
                [tr.Event(e["name"], e["cat"], e["ts"], e["dur"]) for e in events], 2)}


def test_bench_tag_readers(tag_run):
    work = flops_ast.step_flops(tag_run["config"], 64) * 10
    assert read("tag_mfu", tag_run) == pytest.approx(100 * work / (2.0 * 989e12))
    least = flops_ast.k4_least_s(tag_run["config"], 64)
    assert read("k4_roofline", tag_run) == pytest.approx(100 * least / 20e-6)
    assert read("attn_backward_ms_per_step", tag_run) == 120.5


def test_bench_tag_readers_find_nothing_without_k4_or_ranges(tag_run):
    """The parent's program: no ``attention.backward`` range, no K4 launch."""
    bare = dict(tag_run, trace=None, window={k: v for k, v in tag_run["window"].items()
                                             if k != "gpu_ranges_ms_per_step"})
    assert read("k4_roofline", bare) is None and read("attn_backward_ms_per_step", bare) is None
    no_range = dict(tag_run, window=dict(tag_run["window"], gpu_ranges_ms_per_step={}))
    assert read("attn_backward_ms_per_step", no_range) is None


def test_bench_device_ranges_from_a_trace_file(tmp_path):
    """The device-side ``attention.backward`` ranges inside the stretch, ms a
    step; the host ranges of the same name and those outside are left out."""
    events = EVENTS + [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "attention.backward", "ts": 1100.0,
         "dur": 300.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "attention.backward", "ts": 1500.0,
         "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "attention.backward", "ts": 1090.0,
         "dur": 50.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "attention.backward", "ts": 2500.0,
         "dur": 100.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tag_epoch.device_ranges(str(path), ("attention.backward",), 2) == {
        "attention.backward": pytest.approx(0.2)}
    assert tag_epoch.device_ranges(str(path), ("other",), 2) == {}


@pytest.mark.parametrize("name, span", [("copy_ms_per_batch", "predict.copy"),
                                        ("decode_ms_per_batch", "predict.decode")])
def test_bench_predict_span_readers(monkeypatch, name, span):
    log = profiler.Spans()
    for a, b in [(4.0, 4.5), (5.1, 5.2), (5.3, 5.34), (7.5, 7.6)]:  # two inside the window
        log.add(span, a, b)
    run = {"window": {"t0": 5.0, "window_s": 2.0, "steps": 2}}
    monkeypatch.setattr(profiler, "SPANS", log)
    assert read(name, run) == pytest.approx(70.0)
    monkeypatch.setattr(profiler, "SPANS", profiler.Spans())
    assert read(name, run) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_new_cell_is_correct_on_the_card(card, cell):
    result, lines = harness.run_cell(cell, 2 ** 32 + 29, 3.0, False, card, time.perf_counter())
    assert result["correct"] is True, lines
    want = {m["name"] for m in harness.metrics_of(cell, False, harness.benchmark_file())}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_bench_new_cell_control_fails_on_the_card(card, cell):
    w = harness.load("workloads", cell)
    config, traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
    got = dict(READERS[cell](config, traffic, 5, card, ["control"]))["control"]
    assert any(got[k]["value"] > limit for k, limit in w["limits"].items()), got
