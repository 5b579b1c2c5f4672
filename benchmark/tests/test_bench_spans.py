"""The span readers (``benchmark/spans.py`` and its five metrics) on a
hand-written stretch with known overlaps and a span log with known times,
and the ten earlier readers unmoved by the spans' ranges in a trace."""
import pytest

from benchmark import harness
from benchmark import spans as S
from benchmark import trace as tr
from benchmark.tests.test_bench_metrics import EVENTS
from sound_event_detection_transformer_tpu_torch.utils import profiler

READERS = ["issue_ms_per_step", "prefetch_ms_per_batch", "idle_issue_ms_per_step",
           "idle_data_ms_per_step", "epoch_edge_idle_ms"]
EARLIER = ["setup_s", "clips_per_s", "step_ms_p90", "data_wait_ms", "device_idle_pct",
           "launches_per_step", "elementwise_ms_per_step", "conv_ms_per_step", "mfu",
           "k1_roofline"]


def host(name, a, b, cat="user_annotation"):
    return tr.Event(name, cat, float(a), float(b - a))


def kernel(a, b):
    return tr.Event("void at::native::elementwise_kernel<128, 4>", "kernel", float(a), float(b - a))


# one loop call of 2 steps inside a stretch of 0..1000 µs: busy 150-180,
# 300-500, 600-700, 900-920; idle 650 µs
STRETCH = [
    host(tr.STRETCH, 0, 1000),
    host("train.epoch", 100, 800),
    host("train.wait", 100, 200), host("train.gather", 200, 220), host("train.step", 220, 400),
    host("train.forward", 230, 300), host("aten::mm", 240, 260, "cpu_op"),
    host("train.wait", 400, 450), host("train.gather", 450, 460), host("train.step", 460, 650),
    host("train.wait", 650, 660),  # the loop's ended wait, for no batch
    host("train.fetch", 850, 950),
    kernel(150, 180), kernel(300, 500), kernel(600, 700), kernel(900, 920),
]
# µs: issue 220-300 and 500-600; data 200-220; edge 100-150, 180-200, 850-900,
# 920-950; train.epoch outside its children 700-800; outside 0-100, 800-850,
# 950-1000
WANT = {"idle": 650.0, "issue": 180.0, "data": 20.0, "edge": 150.0, "epoch": 100.0,
        "outside": 200.0}


@pytest.fixture
def run():
    log = profiler.Spans()
    for name, a, b in [("train.step", 4.0, 4.5),  # before the window
                       ("train.step", 5.1, 5.2), ("data.batch", 5.05, 5.06),
                       ("train.step", 5.3, 5.45), ("data.batch", 5.2, 5.23),
                       ("train.step", 6.9, 7.1)]:  # past its end
        log.add(name, a, b)
    window = {"t0": 5.0, "window_s": 2.0, "steps": 2, "clips": 512, "intervals_ms": [100.0],
              "data_wait_s": 0.0, "data_waits": 0}
    config = harness.load("configs", "sedt-urbansed")
    return {"config": config, "traffic": harness.load("traffic", "train-b256"), "window": window,
            "setup_s": 1.0, "trace": tr.from_events(STRETCH, steps=2), "log": log}


def read(name, run):
    return harness.read_metrics([{"name": name, "unit": "u"}], run).get(name, {}).get("value")


def test_bench_idle_parts_by_hand(run):
    parts = S.idle_parts(run["trace"])
    assert parts == pytest.approx(WANT)
    assert sum(parts[k] for k in S.PARTS) == pytest.approx(parts["idle"])
    assert parts["idle"] == pytest.approx(1e6 * (run["trace"].window_s - tr.busy_s(run["trace"])))


@pytest.mark.parametrize("name, want", [("idle_issue_ms_per_step", 0.09),
                                        ("idle_data_ms_per_step", 0.01),
                                        ("epoch_edge_idle_ms", 0.15)])
def test_bench_idle_reader(run, name, want):
    assert read(name, run) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [("issue_ms_per_step", 125.0),
                                        ("prefetch_ms_per_batch", 20.0)])
def test_bench_window_span_reader(run, monkeypatch, capsys, name, want):
    monkeypatch.setattr(profiler, "SPANS", run["log"])
    assert read(name, run) == pytest.approx(want)
    if name == "issue_ms_per_step":
        assert "train.step 125.000 (2)" in capsys.readouterr().err


def test_bench_idle_report(run, capsys):
    S.report_idle(run["trace"])
    err = capsys.readouterr().err
    assert "idle outside program spans: 0.200 ms, 30.77 %" in err
    assert "adding up to 0.650" in err and "train.step ranges 2 for 2 steps" in err


@pytest.mark.parametrize("name", READERS)
def test_bench_span_readers_find_nothing_in_a_program_without_spans(run, monkeypatch, name):
    """The parent's program: no span log, no ``train.*`` range."""
    monkeypatch.delattr(profiler, "SPANS")
    bare = [e for e in STRETCH if not e.name.startswith(S.PREFIX)]
    assert read(name, dict(run, trace=tr.from_events(bare, steps=2))) is None
    assert read(name, dict(run, trace=None)) is None


def test_bench_span_log_past_its_reach_reads_nothing(run, monkeypatch):
    log = profiler.Spans(keep=2)
    for a in (5.1, 5.2, 5.3):
        log.add("train.step", a, a + 0.05)
    monkeypatch.setattr(profiler, "SPANS", log)
    assert read("issue_ms_per_step", run) is None


@pytest.mark.parametrize("name", EARLIER)
def test_bench_earlier_readers_unmoved_by_span_ranges(tmp_path, name):
    """The spans' ranges on the host change none of the earlier readings."""
    extra = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
             for n, a, b in [("train.epoch", 1010, 1990), ("train.wait", 1010, 1040),
                             ("train.step", 1040, 1700), ("train.fetch", 1750, 1950)]]
    runs = []
    for events in (EVENTS, EVENTS + extra):
        window = {"window_s": 2.0, "steps": 20, "clips": 20 * 256,
                  "intervals_ms": [90.0] * 18 + [100.0, 200.0], "data_wait_s": 0.04,
                  "data_waits": 20, "t0": 5.0}
        runs.append({"config": harness.load("configs", "sedt-urbansed"),
                     "traffic": harness.load("traffic", "train-b256"), "window": window,
                     "setup_s": 12.5, "trace": tr.from_events(
                         [tr.Event(e["name"], e["cat"], e["ts"], e["dur"]) for e in events], 2)})
    assert read(name, runs[1]) == read(name, runs[0]) is not None
