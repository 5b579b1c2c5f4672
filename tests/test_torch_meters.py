"""The trainer's utilities in the port: ``DeviceMetricAccumulator`` against
the JAX package's (weighted sums, means, NaN kept), ``MetricLogger`` and
``get_reduced_loss``'s lines, ``Heartbeat``, the one-process rank helpers,
the logger, ``utils.profiler`` and ``back_up_code``.  Sums of f32 values on
both sides: 1e-6 relative."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.parallel import distribute as jdistribute
from sound_event_detection_transformer_tpu.utils import meters as jmeters
from sound_event_detection_transformer_tpu_torch.parallel import distribute
from sound_event_detection_transformer_tpu_torch.utils import checkpoint, logger, meters, profiler


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0, 1.0], [4.0, 4.0, 2.0, 3.0]],
                         ids=["unweighted", "weighted"])
def test_accumulator_matches_jax(weights):
    rng = np.random.RandomState(0)
    steps = [{"loss": rng.randn(), "loss_ce": rng.rand(), "counts": rng.rand(3)} for _ in weights]
    tacc, jacc = meters.DeviceMetricAccumulator(), jmeters.DeviceMetricAccumulator()
    for step, w in zip(steps, weights):
        tacc.update({k: torch.tensor(v, dtype=torch.float32) for k, v in step.items()}, weight=w)
        jacc.update({k: jnp.asarray(v, jnp.float32) for k, v in step.items()}, weight=w)
    (tm, tn), (jm, jn) = tacc.means(), jacc.means()
    assert tn == jn == tacc.steps == 4 and tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)
    want = sum(w * s["loss"] for s, w in zip(steps, weights)) / sum(weights)
    np.testing.assert_allclose(tm["loss"], want, rtol=1e-6)


def test_accumulator_keeps_nan_and_starts_empty():
    acc = meters.DeviceMetricAccumulator()
    assert acc.means() == ({}, 0)
    acc.update({"loss": torch.tensor(1.0)})
    acc.update({"loss": torch.tensor(float("nan"))})
    acc.update({"loss": torch.tensor(2.0)})
    assert not np.isfinite(acc.means()[0]["loss"])


def test_metric_logger_and_reduced_loss_match_jax():
    losses = {"loss_ce": 2.0, "loss_bbox": 0.5, "class_error": 80.0}
    weight_dict = {"loss_ce": 1.0, "loss_bbox": 5.0}
    tlog, jlog = meters.MetricLogger(delimiter="  "), jmeters.MetricLogger(delimiter="  ")
    got = distribute.get_reduced_loss(losses, weight_dict, tlog)
    want = jdistribute.get_reduced_loss(losses, weight_dict, jlog)
    assert got == want == 4.5
    tlog.update(lr=1e-5)
    jlog.update(lr=1e-5)
    assert str(tlog) == str(jlog)
    assert tlog.loss_ce.global_avg == 2.0
    with pytest.raises(AttributeError):
        tlog.missing


def test_one_process_helpers():
    assert distribute.get_world_size() == 1 and distribute.get_rank() == 0
    assert distribute.is_main_process()
    assert distribute.reduce_dict({"a": 1.5}) == {"a": 1.5}


def test_heartbeat_is_time_gated(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(meters.time, "time", lambda: now[0])
    lines = []
    hb = meters.Heartbeat(lines.append, total_steps=100, interval_s=60.0)
    now[0] += 10.0
    hb.tick(0)
    assert lines == []
    now[0] += 55.0
    hb.tick(4)
    assert len(lines) == 1 and "[5/100]" in lines[0]


def test_logger_and_step_timer():
    log = logger.create_logger("test_torch_meters")
    assert log is logger.create_logger("test_torch_meters") and log.level == logging.INFO
    timer = profiler.StepTimer()
    with profiler.annotate("train.wait") as wait:
        pass
    timer.data_loaded(wait.seconds)
    timer.step_done()
    assert "data_time" in timer.summary() and timer.batch_time.count == 1
    assert "wait " in timer.summary() and timer.data_time.sum == wait.seconds


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.annotate("the_range"):
            torch.ones(4).sum()
    (trace,) = tmp_path.glob("*.json")
    assert "the_range" in trace.read_text()


def test_back_up_code_copies_the_package(tmp_path):
    dst = checkpoint.back_up_code(str(tmp_path), "run")
    copied = {p.name for p in (tmp_path / "code_backup" / "run").rglob("*.py")}
    assert dst.endswith("run") and {"train_lib.py", "checkpoint.py", "psds.py"} <= copied
    assert not list((tmp_path / "code_backup" / "run").rglob("__pycache__"))
