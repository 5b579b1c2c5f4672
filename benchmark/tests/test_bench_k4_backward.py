"""``k4_backward_roofline`` on canned traces: the backward kernels' summed
time over the count of ``flash_bwd_dkdv_kernel`` launches; nothing without
them (the parent's program); and K4's forward and backward kept apart."""
import pytest

from benchmark import harness
from benchmark import trace as tr
from benchmark.metrics import k4_backward_roofline
from benchmark.tests.test_bench_metrics import EVENTS

NAMESPACE = "void (anonymous namespace)::"
FORWARD = {"ph": "X", "cat": "kernel", "name": NAMESPACE + "flash_mma_kernel<64, 4, 2>(bf16)",
           "ts": 1600.0, "dur": 20.0}


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": NAMESPACE + name, "ts": ts, "dur": dur}


# two backward calls in the stretch (each: row constants, dK and dV, dQ) and
# one launch after it, which does not count
BACKWARD = [kernel("flash_bwd_dot_kernel<64>(bf16)", 1100.0, 5.0),
            kernel("flash_bwd_dkdv_kernel<64, 4>(bf16)", 1110.0, 60.0),
            kernel("flash_bwd_dq_kernel<64, 4>(bf16)", 1180.0, 35.0),
            kernel("flash_bwd_dot_kernel<64>(bf16)", 1700.0, 5.0),
            kernel("flash_bwd_dkdv_kernel<64, 4>(bf16)", 1710.0, 60.0),
            kernel("flash_bwd_dq_kernel<64, 4>(bf16)", 1780.0, 35.0),
            kernel("flash_bwd_dkdv_kernel<64, 4>(bf16)", 2500.0, 60.0)]


def tag_run(extra):
    config = harness.load("configs", "ast-audioset")
    window = {"window_s": 2.0, "steps": 10, "clips": 640, "intervals_ms": [200.0] * 10,
              "data_wait_s": 0.0, "data_waits": 10, "t0": 5.0}
    events = [tr.Event(e["name"], e["cat"], e["ts"], e["dur"]) for e in EVENTS + extra]
    return {"config": config, "traffic": harness.load("traffic", "tag-b64"), "window": window,
            "setup_s": 1.0, "trace": tr.from_events(events, 2)}


def read(name, run):
    return harness.read_metrics([{"name": name, "unit": "%"}], run).get(name, {}).get("value")


def test_bench_k4_backward_least_time_at_the_cells_shape():
    config = harness.load("configs", "ast-audioset")
    # five products of 2 B H N^2 D at [64, 12, 1214, 64]: 0.7325 ms, above
    # the bytes' 0.287 ms
    assert k4_backward_roofline.least_s(config, 64) == pytest.approx(
        5 * 2 * 64 * 12 * 1214 ** 2 * 64 / 989e12)
    assert k4_backward_roofline.least_s(config, 64) * 1e3 == pytest.approx(0.7325, abs=1e-4)


def test_bench_k4_backward_roofline_divides_every_backward_kernel_by_the_calls():
    run = tag_run([FORWARD] + BACKWARD)
    least = k4_backward_roofline.least_s(run["config"], 64)
    assert read("k4_backward_roofline", run) == pytest.approx(100 * least * 2 / 200e-6)


@pytest.mark.parametrize("extra", [[], [FORWARD]], ids=["nothing", "forward_only"])
def test_bench_k4_backward_roofline_reads_nothing_without_the_backward(extra):
    """The parent's program launches no backward kernel; K4's forward does
    not enter the backward's reading."""
    assert read("k4_backward_roofline", tag_run(extra)) is None
    assert read("k4_backward_roofline", dict(tag_run(extra), trace=None)) is None


def test_bench_k4_roofline_leaves_the_backward_out():
    with_backward, alone = tag_run([FORWARD] + BACKWARD), tag_run([FORWARD])
    assert read("k4_roofline", with_backward) == read("k4_roofline", alone) is not None
    assert read("k4_roofline", tag_run(BACKWARD)) is None
