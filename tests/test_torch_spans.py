"""The port's spans (``utils.profiler.annotate`` and ``SPANS``): per-name
host-clock totals, nested and from other threads, the span log read back by
clock bounds, no dispatcher call with the profiler off, a
``user_annotation`` range under it, and the spans of one call of the
training loop over two steps, through each of its entry points
(``train_lib.train_one_epoch`` and ``train_lib.train_audio_tag_epoch``)."""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.data.dataset import (ConcatDataset,
                                                                       MultiStreamBatchSampler)
from sound_event_detection_transformer_tpu_torch.data.feature_bank import maybe_bank
from sound_event_detection_transformer_tpu_torch.engine import init_train_state, make_train_step
from sound_event_detection_transformer_tpu_torch.parallel.optim import make_audio_tag_optimizer
from sound_event_detection_transformer_tpu_torch.utils import profiler
from sound_event_detection_transformer_tpu_torch.utils.profiler import SPANS, annotate

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)
TINY = ["--dataname", "urbansed", "--synthetic_smoke", "--smoke_clips", "4", "--batch_size", "2",
        "--backbone", "resnet18", "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
        "--dec_layers", "1", "--dim_feedforward", "64", "--num_queries", "4",
        "--compute_dtype", "float32"]
LOOP = {"train.epoch": 1, "train.wait": 2, "train.gather": 2, "train.step": 2,
        "train.augment": 2, "train.forward": 2, "train.criterion": 2, "train.backward": 2,
        "train.optimizer": 2, "train.fetch": 1, "data.batch": 2}
# the audio tagger's loop: no bank, no augmentation, no matching, and its
# batches (``weak_batches``) open no ``data.batch``
TAG_LOOP = {"train.epoch": 1, "train.wait": 2, "train.step": 2, "train.forward": 2,
            "train.backward": 2, "train.optimizer": 2, "train.fetch": 1}


class _Quiet:
    @staticmethod
    def info(*_args, **_kw):
        return None


def test_nested_spans_add_per_name_totals():
    before = SPANS.totals()
    with annotate("t.outer") as outer:
        for _ in range(3):
            with annotate("t.inner"):
                time.sleep(0.002)
    got = SPANS.since(before)
    assert got["t.outer"].count == 1 and got["t.inner"].count == 3
    assert got["t.outer"].seconds == outer.seconds >= got["t.inner"].seconds >= 0.006
    assert set(got) == {"t.outer", "t.inner"}


def test_span_that_raises_is_left_out():
    before = SPANS.totals()
    with pytest.raises(StopIteration):
        with annotate("t.raised"):
            next(iter([]))
    assert "t.raised" not in SPANS.since(before)


def test_totals_from_other_threads_lose_no_update():
    """More threads than cores, each adding spans, with a short switch
    interval: every span is counted once."""
    def spans():
        for _ in range(500):
            with annotate("t.thread"):
                pass

    before, interval = SPANS.totals(), sys.getswitchinterval()
    threads = [threading.Thread(target=spans) for _ in range(16)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert SPANS.since(before)["t.thread"].count == 16 * 500


def test_log_reads_a_stretch_of_time_back():
    log = profiler.Spans(keep=3)
    for name, a, b in [("x", 1.0, 1.5), ("x", 2.0, 2.5), ("y", 2.2, 2.3), ("x", 2.9, 3.1)]:
        log.add(name, a, b)
    assert log.between(2.0, 3.0) == {"x": (1, 0.5), "y": (1, pytest.approx(0.1))}
    assert log.between(1.9, 3.0) is None  # a span dropped from the log may have begun at 1.9
    assert log.totals()["x"] == (3, pytest.approx(1.2))


def test_profiler_off_makes_no_dispatcher_call(monkeypatch):
    def refuse(*_a, **_kw):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with annotate("t.off"):
        pass


def test_under_the_profiler_a_span_is_a_user_annotation(tmp_path):
    """The main thread's span opens a range; another thread's keeps to the
    host clock."""
    before = SPANS.totals()

    def other():
        with annotate("t.other_thread"):
            torch.ones(4).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("t.profiled"):
            torch.ones(4).sum()
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name") == "t.profiled"}
    assert cats == {"user_annotation"}
    assert not [e for e in events if e.get("name") == "t.other_thread"]
    assert {"t.profiled", "t.other_thread"} <= set(SPANS.since(before))


def _train_one_epoch():
    args = train_lib.get_parser().parse_args(TINY)
    cfg = train_lib.args_to_config(args)
    data = ConcatDataset([train_lib.build_synthetic_data(cfg, args)["train"]])
    dev = torch.device("cpu")
    model, weight_dict = train_lib.init_model(cfg, dev)
    state = init_train_state(model, cfg, 2)
    step = make_train_step(model, weight_dict, cfg, state.optimizer, device=dev)
    sampler = MultiStreamBatchSampler(data, [2], seed=0)
    bank = maybe_bank(args, data, cfg, dev)
    assert bank is not None and len(sampler) == 2
    return lambda: train_lib.train_one_epoch(step, data, sampler, cfg, bank,
                                             torch.Generator().manual_seed(0), _Quiet())


def _train_audio_tag_epoch():
    """A tiny ``AudioTagBackbone`` step on two batches of two clips."""
    args = train_lib.get_parser().parse_args(TINY)
    cfg = train_lib.args_to_config(args)
    data = train_lib.build_audio_tag_data(cfg, args)["train"]
    dev = torch.device("cpu")
    model = train_lib.init_audio_tag_model(cfg, "avg", dev)
    step = train_lib.make_audio_tag_step(model, make_audio_tag_optimizer(
        model, 1e-4, 100, 2, train_lib.AT_CLIP_MAX_NORM))
    return lambda: train_lib.train_audio_tag_epoch(step, data, [[0, 1], [2, 3]], dev)


@pytest.fixture(scope="module", params=[(_train_one_epoch, LOOP),
                                        (_train_audio_tag_epoch, TAG_LOOP)],
                ids=["train_one_epoch", "train_audio_tag_epoch"])
def loop(request):
    """One call of an entry point of the training loop: (the spans it
    opened, its step timer, the span counts it should open)."""
    make, want = request.param
    epoch = make()
    before = SPANS.totals()
    acc, timer = epoch()
    acc.means()
    return SPANS.since(before), timer, want


def test_train_one_epoch_opens_every_span(loop):
    spans, _, want = loop
    assert {k: v.count for k, v in spans.items()} == want


def test_step_timer_data_time_is_the_wait_spans(loop):
    spans, timer, want = loop
    assert (timer.data_time.count, timer.data_time.sum) == spans["train.wait"]
    assert timer.batch_time.count == 2
    assert timer.spans()["train.step"] == spans["train.step"]
    line = timer.summary()
    assert all(f" {k.split('.')[1]} " in line for k in want if k not in ("train.epoch",))


def test_span_cost_tool_prints_its_line():
    out = subprocess.run([sys.executable, "tools/span_cost_torch.py", "--n", "1000"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] == 1000 and isinstance(got["thread_range_in_trace"], bool)
    assert 0 < got["span_off_us"] < got["span_on_us"]
