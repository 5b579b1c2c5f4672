"""The port's supervised trainer, ``train_lib.run_supervised`` on
``--synthetic_smoke``, against the JAX package's on URBAN-SED-layout data
(``tests/test_torch_trainer_dcase.py`` holds the DCASE layout), and the
trainer's own paths: resume, ``--eval``, early stopping and the layout
that several processes cannot run (a global batch that does not divide
over them, here and in the audio-tag trainer).  The
trainer on a dataset on disk is ``tests/test_torch_trainer_disk.py``.

Both trainers start from the same parameters: the test rebuilds the JAX
trainer's initial ones (its ``init_train_state`` with ``PRNGKey(seed)``) and
hands them to the port through ``weights.from_flax``, in place of the port's
``train_lib.init_model``.  Tiny size (resnet18, d 64, 1+1 layers, FFN 128),
batch 4, 16 training clips, 2 epochs, f32, dropout 0, no augmentation and
``--epochs_ls`` past the end, so no random draw decides anything.

Tolerances of the loss means, derived from PR 5's gradient-noise finding:
JAX's CPU f32 gradients are off by up to 4e-3 of a leaf's largest entry
(the port's by about 1e-6).  Adam's first steps are about lr * sign(g), so
an entry whose gradient sits at that noise level may step the other way, by
up to 2 lr, and the two runs drift apart a little more with each update.

* epoch 0 (its train steps and the validation after them, 2-4 updates):
  rtol 2e-4, atol 1e-6; few entries have flipped yet (measured: up to 5e-5);
* later epochs: rtol 5e-3, atol 1e-5, the gradient noise rounded up.  After
  4-8 updates the means differ by up to 2.4e-3 (the DCASE layout's weak
  loss, whose batches hold two weak clips); a perturbation of the initial
  weights by 1e-6 of their size moves them by 4e-5 at most, one of 2e-3 by
  1-4 %, so the runs follow the parameters smoothly, and a wrong loss term
  or update would show far above the bound.
"""
import contextlib
import io
import logging
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.utils import checkpoint as jcheckpoint
from sound_event_detection_transformer_tpu.utils import meters as jmeters
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.utils import checkpoint
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL_FIRST = dict(rtol=2e-4, atol=1e-6)  # epoch 0
TOL = dict(rtol=5e-3, atol=1e-5)  # later epochs
TINY = ["--synthetic_smoke", "--smoke_clips", "16", "--batch_size", "4", "--backbone",
        "resnet18", "--hidden_dim", "64", "--enc_layers", "1", "--dec_layers", "1",
        "--dim_feedforward", "128", "--epochs", "2", "--epochs_ls", "10", "--dropout", "0",
        "--compute_dtype", "float32", "--dec_at", "--fusion_strategy", "1", "2", "3",
        "--checkpoint_epochs", "1", "--log", "--info", "tiny"]


def tiny_argv(dataname):
    return ["--dataname", dataname] + TINY + (["--n_weak", "2"] if dataname == "dcase" else [])


def run_both(argv, tmp_path, jax_extra=(), torch_extra=()):
    """JAX's ``run_supervised`` and the port's on ``argv`` (each with its
    ``*_extra`` arguments) from the same initial parameters: (JAX's epoch
    means, JAX's validation means, JAX's result, the port's result, the two
    model dirs)."""
    jargs = jtrain_lib.get_parser().parse_args(argv + ["--exp_root", str(tmp_path / "jax")]
                                               + list(jax_extra))
    recorded = []
    real_means = jmeters.DeviceMetricAccumulator.means

    def means(self):
        out = real_means(self)
        recorded.append(dict(out[0]))
        return out

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jmeters.DeviceMetricAccumulator, "means", means)
        jresult = jtrain_lib.run_supervised(jargs)

    jcfg = jtrain_lib.args_to_config(jargs)
    jmodel, _ = jbuild(jcfg)
    b, t, f = jcfg.data.batch_size, jcfg.model.max_frames, jcfg.model.n_mels
    v = jax.jit(lambda r: jmodel.init({"params": r, "dropout": r}, jnp.zeros((b, t, f, 1)),
                                      jnp.zeros((b, t), bool), True))(
        jax.random.PRNGKey(jcfg.train.seed))
    state = from_flax(jax.tree.map(np.asarray, flax.core.unfreeze(v["params"])),
                      jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])))

    def init_model(cfg, device):
        model, wd = build_model(cfg, device=device)
        model.load_state_dict(state, strict=True)
        return model, wd

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "init_model", init_model)
        tresult = train_lib.run_supervised(
            cli.sedt_args(argv + ["--exp_root", str(tmp_path / "torch")] + list(torch_extra)),
            device="cpu")
    dataname = argv[1]
    return (
        [r for r in recorded if "loss" in r], [r for r in recorded if "loss" not in r],
        jresult, tresult,
        tmp_path / "jax" / dataname / "model", tmp_path / "torch" / dataname / "model",
    )


def assert_runs_match(run, steps):
    jtrain, jval, jresult, tresult, jdir, tdir = run
    epochs = tresult.epochs
    assert len(epochs) == len(jtrain) == len(jval) == 2
    for e, (rec, jt, jv) in enumerate(zip(epochs, jtrain, jval)):
        tol = TOL_FIRST if e == 0 else TOL
        assert rec["steps"] == steps and not rec["fine_tune"] and rec["lr"] == 1e-4
        assert rec["loss_means"].keys() == jt.keys() and rec["val_loss_means"].keys() == jv.keys()
        for k, w in jt.items():
            np.testing.assert_allclose(rec["loss_means"][k], w, err_msg=f"epoch {e} {k}", **tol)
        for k, w in jv.items():
            np.testing.assert_allclose(rec["val_loss_means"][k], w, err_msg=f"val {e} {k}",
                                       **tol)
        assert np.isfinite(rec["loss"])
    assert tresult.f1.keys() == jresult.keys() == {3}
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "tiny_0", "tiny_1", "tiny_1_best", "tiny_2_best", "tiny_3_best"]
    assert tresult.bank and [r["fusion_strategy"] for r in tresult.final] == [1, 2, 3]


@pytest.fixture(scope="module")
def urbansed(tmp_path_factory):
    return run_both(tiny_argv("urbansed"), tmp_path_factory.mktemp("urbansed"))


def test_urbansed_trainer_matches_jax(urbansed):
    assert_runs_match(urbansed, steps=4)  # 16 clips at batch 4


def test_resume_reproduces_the_next_epoch(urbansed):
    """From the periodic checkpoint of epoch 0, the resumed run's epoch 1
    equals the uninterrupted run's bit for bit: the model, AdamW's moments
    and counts, the sampler's permutation stream, the step's generator and
    the best-model policies all come back."""
    *_, result, _, tdir = urbansed
    exp_root = tdir.parent.parent
    with contextlib.redirect_stdout(io.StringIO()):
        resumed = train_lib.run_supervised(
            cli.sedt_args(tiny_argv("urbansed") + ["--exp_root", str(exp_root),
                                                   "--resume", "tiny_0"]),
            device="cpu")
    assert [r["epoch"] for r in resumed.epochs] == [1]
    want, got = result.epochs[1], resumed.epochs[0]
    assert got["loss_means"] == want["loss_means"]
    assert got["val_loss_means"] == want["val_loss_means"]
    assert got["val_f1"] == want["val_f1"]
    ck = checkpoint.load_checkpoint(str(tdir / "tiny_0"))
    assert ck["epoch"] == 0 and ck["optimizer"]["updates"] == 4
    # the checkpoints' keys, which a resume of an older run's files reads
    periodic = {"model", "optimizer", "epoch", "sampler", "generator", "save_best", "early"}
    assert set(ck) == periodic
    assert set(checkpoint.load_checkpoint(str(tdir / "tiny_1"))) == periodic
    for m in (1, 2, 3):
        best = checkpoint.load_checkpoint(str(tdir / f"tiny_{m}_best"))
        assert set(best) == {"model", "epoch", f"event_based_f1_{m}"}


def test_eval_runs_the_final_test_only(urbansed):
    """``--eval`` (which needs ``--info``) trains nothing and tests each
    strategy's best checkpoint, as the training run's own final test did."""
    *_, result, _, tdir = urbansed
    argv = tiny_argv("urbansed") + ["--exp_root", str(tdir.parent.parent), "--eval"]
    args = cli.sedt_args(argv)
    assert args.epochs == 0
    with contextlib.redirect_stdout(io.StringIO()):
        got = train_lib.run_supervised(args, device="cpu")
    assert got.epochs == []
    assert [r["loaded"] for r in got.final] == [r["loaded"] for r in result.final]
    assert got.f1 == result.f1
    for r, w in zip(got.final, result.final):
        assert (r["valid_f1"], r["eval_f1"]) == (w["valid_f1"], w["eval_f1"])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.sedt_args([a for a in argv if a not in ("--info", "tiny")])


def test_default_info_names_the_configuration():
    args = cli.sedt_args(["--dataname", "urbansed", "--fusion_strategy", "1", "2"])
    assert args.info == "urbansed_atloss_1_atploss_1_enc_3_pooling_None_[1, 2]"


def test_early_stopping_ends_the_run(tmp_path, monkeypatch):
    """With patience 0 past one epoch of grace, F1 that never improves
    stops the run after its first evaluation; the final test still runs."""
    monkeypatch.setattr(train_lib, "EarlyStopping",
                        lambda **kw: checkpoint.EarlyStopping(
                            patience=0, init_patience=1, fusion_strategy=kw["fusion_strategy"]))
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger("train_sedt_torch").addHandler(handler)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = train_lib.run_supervised(
                cli.sedt_args(tiny_argv("urbansed") + ["--epochs", "3", "--exp_root",
                                                       str(tmp_path)]),
                device="cpu")
    finally:
        logging.getLogger("train_sedt_torch").removeHandler(handler)
    assert len(result.epochs) == 1 and "EARLY STOPPING" in records
    assert len(result.final) == 3


@pytest.mark.parametrize("seq", [[0.1, 0.2, 0.2, 0.2, 0.1, 0.3], [0.5, 0.4, 0.3, 0.2, 0.1, 0.0]])
def test_save_best_and_early_stopping_match_jax(seq):
    """The policies decide as the JAX package's do, strategies in turn, and
    their state round-trips."""
    tsave, jsave = checkpoint.SaveBest("sup"), jcheckpoint.SaveBest("sup")
    tstop = checkpoint.EarlyStopping(patience=1, init_patience=1, fusion_strategy=(1, 2))
    jstop = jcheckpoint.EarlyStopping(patience=1, init_patience=1, fusion_strategy=(1, 2))
    for v in seq:
        assert tsave.apply(v) == jsave.apply(v)
        assert tstop.apply(v) == jstop.apply(v)
    assert tsave.state_dict() == jsave.state_dict()
    assert tstop.state_dict() == jstop.state_dict()
    back = checkpoint.EarlyStopping(fusion_strategy=(1, 2))
    back.load_state_dict(tstop.state_dict())
    assert back.state_dict() == tstop.state_dict()


@pytest.mark.parametrize("trainer", ["audio_tag", "processes"])
def test_paths_left_out_raise(trainer, tmp_path, monkeypatch):
    """Several processes raise in the supervised trainer and in the
    audio-tag trainer when the global batch (4) does not divide over them
    (3), before they write anything."""
    monkeypatch.setattr(train_lib, "get_world_size", lambda: 3)
    exp = ["--exp_root", str(tmp_path / "exp")]
    if trainer == "processes":
        run = lambda: train_lib.run_supervised(cli.sedt_args(tiny_argv("urbansed") + exp),
                                               device="cpu")
    else:
        run = lambda: train_lib.run_audio_tag(
            cli.at_args(["--synthetic_smoke", "--log"] + exp), device="cpu")
    with pytest.raises(ValueError, match="does not divide over 3 processes"):
        run()
    assert not (tmp_path / "exp").exists()
