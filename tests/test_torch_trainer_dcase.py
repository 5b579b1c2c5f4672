"""The port's supervised trainer against the JAX package's on DCASE-layout
synthetic data (a strong and a weak stream, ``--n_weak 2`` of batch 4), and
the fine-tune stage that ``--epochs_ls`` starts.  The set-up, the shared
initial parameters and the tolerance are those of
``tests/test_torch_trainer.py``."""
import contextlib
import io

import pytest
import torch

from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.utils import checkpoint
from test_torch_trainer import assert_runs_match, run_both, tiny_argv

torch.set_num_threads(2)


def test_dcase_trainer_matches_jax(tmp_path):
    # 2 steps an epoch: the weak stream's 4 clips at 2 a batch
    assert_runs_match(run_both(tiny_argv("dcase"), tmp_path), steps=2)


def test_fine_tune_stage(tmp_path, monkeypatch):
    """At ``--epochs_ls`` the trainer reloads ``{info}_1_best``, takes a new
    optimizer at the fixed lr 1e-5, matches with the fine-tune rule and
    writes its checkpoints under ``{info}_ft``."""
    loaded = []
    real_load = train_lib.load_checkpoint
    monkeypatch.setattr(train_lib, "load_checkpoint",
                        lambda path: (loaded.append(path), real_load(path))[1])
    fine_tune_steps = []
    real_make = train_lib.make_train_step
    monkeypatch.setattr(train_lib, "make_train_step",
                        lambda *a, **kw: (fine_tune_steps.append(kw["fine_tune"]),
                                          real_make(*a, **kw))[1])
    with contextlib.redirect_stdout(io.StringIO()):
        result = train_lib.run_supervised(
            cli.sedt_args(tiny_argv("dcase") + ["--epochs", "3", "--epochs_ls", "2",
                                                "--exp_root", str(tmp_path)]),
            device="cpu")
    model_dir = tmp_path / "dcase" / "model"
    assert [r["lr"] for r in result.epochs] == [1e-4, 1e-4, 1e-5]
    assert [r["fine_tune"] for r in result.epochs] == [False, False, True]
    assert fine_tune_steps == [False, True]
    assert result.epochs[2]["reloaded"] == str(model_dir / "tiny_1_best")
    assert loaded[0] == str(model_dir / "tiny_1_best")
    assert checkpoint.load_checkpoint(loaded[0])["epoch"] in (0, 1)
    assert (model_dir / "tiny_ft_2").exists()  # the periodic checkpoint of the stage
    # the stage's optimizer runs at 1e-5
    ck = checkpoint.load_checkpoint(str(model_dir / "tiny_ft_2"))
    assert [g["lr"] for g in ck["optimizer"]["adamw"]["param_groups"]] == [1e-5, 1e-5]
    assert ck["optimizer"]["updates"] == 2  # one epoch of the new optimizer
