"""The host-side tools on the port: ``tools/bench_host_metrics_torch.py``
against the JAX package's metrics, and the two JAX-side tools that need no
copy, ``tools/watchdog_run.py`` and ``tools/parse_acc_log.py``, on a port
trainer's checkpoints and log.

``bench_host_metrics_torch.run`` at N = 64 draws the JAX tool's evaluation
in its order; the port's ``compute_metrics`` and its PSDS over the nine
operating points must match the JAX package's on DataFrames built from the
same rows, to ``tests/test_torch_metrics.py``'s 1e-9.  The JAX-side tools
are loaded by path and stay as they are: a tiny trainer run with
``--checkpoint_epochs 1`` writes ``<info>_<epoch>`` checkpoints that
``watchdog_run.newest_checkpoint`` finds, the run that ``with_resume``
makes resumes from it, and ``parse_acc_log.parse`` reads the trainer's log
(its ``Epoch N: loss``, ``Metric on validation`` and ``Fusion strategy``
lines and the event-based table's macro average) into its epochs and F1.
"""
import contextlib
import importlib.util
import io
import logging
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from sound_event_detection_transformer_tpu import metrics as jm
from sound_event_detection_transformer_tpu_torch import cli
from sound_event_detection_transformer_tpu_torch import metrics as tm

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT / "tools"))

import bench_host_metrics_torch as bhm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=0, atol=1e-9)
COLS = ["filename", "onset", "offset", "event_label"]
TINY = ["--dataname", "urbansed", "--synthetic_smoke", "--smoke_clips", "16", "--batch_size",
        "4", "--backbone", "resnet18", "--hidden_dim", "64", "--enc_layers", "1",
        "--dec_layers", "1", "--dim_feedforward", "128", "--epochs_ls", "10", "--dropout", "0",
        "--compute_dtype", "float32", "--dec_at", "--fusion_strategy", "2",
        "--checkpoint_epochs", "1", "--log", "--info", "tiny"]
LOGGERS = ("train_sedt_torch", "sound_event_detection_transformer_tpu_torch.train_lib/evaluate")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_host_metrics_matches_jax_on_dataframes():
    with contextlib.redirect_stdout(io.StringIO()):
        got = bhm.run(64)
        ev = got["ev"]
        ref = pd.DataFrame(ev["ref"], columns=COLS)
        want_f1 = jm.compute_metrics(pd.DataFrame(ev["pred"], columns=COLS + ["score"]), ref,
                                     cal_seg=True, cal_clip=True)
        psds = jm.PSDSEval(ground_truth=ref,
                           metadata=pd.DataFrame(ev["meta"], columns=["filename", "duration"]))
        for rows in got["ops"]:
            psds.add_operating_point(pd.DataFrame(rows, columns=COLS))
    assert len(ev["ref"]) == 128 and len(ev["pred"]) == 320 and len(ev["batches"]) == 1
    assert len(got["ops"]) == 9 and len(got["ops"][0]) > len(got["ops"][-1])
    np.testing.assert_allclose(got["f1"], want_f1, **TOL)
    want = [psds.psds(alpha_ct=a, alpha_st=s, max_efpr=100).value
            for a, s in ((0, 0), (1, 0), (0, 1))]
    np.testing.assert_allclose(got["psds"], want, **TOL)
    # at N = 64 random detections match no event within the collar (F1 0, as
    # the JAX tool's draws give), so the segment-based F1 of the same rows,
    # which compute_metrics reports, is held too
    assert got["f1"] == 0 and got["psds"][0] > 0
    pred = pd.DataFrame(ev["pred"], columns=COLS + ["score"])
    seg = [r.results_class_wise_average_metrics()["f_measure"]["f_measure"] for r in (
        tm.segment_based_evaluation(ev["ref"], ev["pred"]),
        jm.segment_based_evaluation_df(ref, pred))]
    assert seg[0] > 0
    np.testing.assert_allclose(seg[0], seg[1], **TOL)
    assert set(got["seconds"]) == {"compute_metrics", "decode", "matching", "score"}


def test_bench_host_metrics_draws_the_jax_tools_rows():
    """The first draws of ``RandomState(0)`` in the JAX tool's order."""
    rng = np.random.RandomState(0)
    o = rng.uniform(0, 8)
    first = ("f0.wav", o, o + rng.uniform(0.3, 2), bhm.CLASSES[rng.randint(10)])
    ev = bhm.synthetic_evaluation(2, b=2)
    assert ev["ref"][0] == first and len(ev["ref"]) == 4 and len(ev["pred"]) == 10
    assert ev["meta"] == [("f0.wav", 10.0), ("f1.wav", 10.0)]
    scores, labels, boxes, idx = ev["batches"][0]
    assert scores.shape == labels.shape == (2, bhm.Q) and boxes.shape == (2, bhm.Q, 2)
    assert (boxes[..., 1] <= 10.0).all() and idx.tolist() == [0, 1]


@contextlib.contextmanager
def _log_into(buf):
    """Print and log (the trainer's loggers) into ``buf``, in order."""
    with contextlib.redirect_stdout(buf):
        handlers = []
        for name in LOGGERS:
            for h in logging.getLogger(name).handlers:
                if isinstance(h, logging.StreamHandler):
                    handlers.append((h, h.setStream(buf)))
        try:
            yield
        finally:
            for h, old in handlers:
                h.setStream(old)


def test_watchdog_and_acc_log_serve_the_port_trainer(tmp_path):
    watchdog = _load("watchdog_run")
    parse_acc_log = _load("parse_acc_log")
    for name in LOGGERS:  # the loggers exist before their streams are swapped
        from sound_event_detection_transformer_tpu_torch.utils.logger import create_logger
        create_logger(name)
    argv = TINY + ["--exp_root", str(tmp_path / "exp")]
    buf = io.StringIO()
    with _log_into(buf):
        first = cli.main_sedt(argv + ["--epochs", "1"], device="cpu")
    model_dir = first.model_dir
    assert watchdog.newest_checkpoint(model_dir, "tiny") == "tiny_0"
    assert watchdog.newest_checkpoint(str(tmp_path / "none"), "tiny") is None
    log = tmp_path / "train.log"
    log.write_text(buf.getvalue())
    rows = parse_acc_log.parse(str(log))
    # epoch 0's validation, then the final test's (the best model's), each
    # with the events its fusion strategy decoded (random weights: F1 0)
    assert [(e, f1) for e, _, f1 in rows] == [
        (0, round(first.epochs[0]["val_f1"][2] * 100, 1)),
        (0, round(first.final[0]["valid_f1"] * 100, 1))]
    assert all(n > 0 for _, n, _ in rows)

    resumed_cmd = watchdog.with_resume(argv + ["--epochs", "2"], "tiny_0")
    assert resumed_cmd[-2:] == ["--resume", "tiny_0"]
    buf = io.StringIO()
    with _log_into(buf):
        resumed = cli.main_sedt(resumed_cmd, device="cpu")
    assert [r["epoch"] for r in resumed.epochs] == [1]
    assert watchdog.newest_checkpoint(model_dir, "tiny") == "tiny_1"
    assert watchdog.with_resume(resumed_cmd, "tiny_1")[-2:] == ["--resume", "tiny_1"]
    log.write_text(buf.getvalue())
    rows = parse_acc_log.parse(str(log))
    assert [(e, f1) for e, _, f1 in rows[:1]] == [
        (1, round(resumed.epochs[0]["val_f1"][2] * 100, 1))]
