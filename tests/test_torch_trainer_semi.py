"""The port's mean-teacher trainer, ``train_lib.run_semi``, against the JAX
package's on ``--synthetic_smoke``, and its own paths: resume, ``--eval``,
the arguments.  ``tests/test_torch_trainer_semi_disk.py`` holds the DCASE
layout on disk, with this file's harness.

* Side by side on ``--synthetic_smoke`` (16 strong-stream clips, 16 weak
  and 16 unlabeled at 128 x 64, 4 steps an epoch; 16 validation clips), at
  the tiny size (resnet18, d 64, 1+2 layers, FFN 128, 6 queries,
  ``dec_at``), semi batch 8 (2 strong, 2 weak, 4 unlabeled), 2 epochs,
  dropout 0, f32, no mixup and no masks.
* The student's noisy view is the clean one times 1.0625 in both packages
  (this file patches each package's ``gaussian_noise_pair``), so the two
  packages' random streams decide nothing.  A view equal to the clean one
  (noise at an SNR of 4000 dB, which is 0.0 in f32) would not do: the
  teacher starts as the student, so its pseudo boxes would equal the
  student's predictions on the first step and the box losses would sit at
  their kink, where the two packages' forwards, 1e-7 apart, pick different
  subgradients (the epoch-0 loss means then part by 1.4 %).
* lr 1e-5 (the supervised trainer's fine-tune lr) for both groups.  At the
  default 1e-4 this tiny semi run is chaotic: perturbing the port's initial
  weights by 1e-6 of their size moves epoch 1's loss mean by 1.7e-3, by
  1e-4 of their size 1.3 %, so JAX's CPU f32 gradient noise (up to 4e-3 of
  a leaf's largest entry, ``test_torch_train_step``) parts the two packages
  by 2.4e-3 in epoch 0, past ``test_torch_trainer``'s tolerances.  At 1e-5
  they agree to 2e-6.
* Both start from the same ``--teacher_model``: the JAX trainer's initial
  parameters with class 2's logit bias raised by 6 and its audio-tag bias
  by 4, saved as a flax checkpoint for the JAX side and as ``{"model":
  from_flax(...)}`` for the port, so the teacher labels every unlabeled
  clip (the pseudo counts are above 0).  At initialisation every query of
  a clip leaves the decoder with nearly the same output, so one class
  takes every pseudo event; ``tests/test_torch_semi.py`` holds the
  thresholds' adaptation on counts spread over the classes.
* Each epoch's loss mean to ``test_torch_trainer``'s tolerances (epoch 0
  rtol 2e-4, epoch 1 5e-3), epoch 0's pseudo counts exactly, the adapted
  thresholds to 1e-6 in every epoch whose counts agree.
* The port's ``--resume`` from its epoch-0 checkpoint reproduces epoch 1 bit
  for bit (the student, the teacher, AdamW, the thresholds, the policies,
  the sampler's stream and the step's generator come back); ``--eval``
  tests the best teacher; ``cli.semi_args``' defaults, ``--ema_m``, the
  dataset check and ``--eval``; the teacher checkpoint is required on a
  dataset, and several processes raise.
"""
import contextlib
import io

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu import engine as jengine
from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.ops import augment as jaugment
from sound_event_detection_transformer_tpu.utils import checkpoint as jcheckpoint
from sound_event_detection_transformer_tpu.utils import meters as jmeters
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.ops import augment
from sound_event_detection_transformer_tpu_torch.utils import checkpoint
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_trainer import TOL, TOL_FIRST

torch.set_num_threads(2)
TINY = ["--dataname", "dcase", "--semi_batch_size", "8", "--backbone", "resnet18",
        "--hidden_dim", "64", "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
        "128", "--num_queries", "6", "--epochs", "2", "--dropout", "0", "--compute_dtype",
        "float32", "--dec_at", "--checkpoint_epochs", "1", "--log", "--info", "semi", "--lr",
        "1e-5", "--lr_backbone", "1e-5", "--teacher_model", "teacher"]
SMOKE = TINY + ["--synthetic_smoke", "--smoke_clips", "16"]
RAISED = 2  # the class the teacher checkpoint favours


def _fixed_view(feats, rng_or_generator, snr=30.0, p=0.5):
    """The (clean, noisy) pair without a random draw: the noisy view is the
    clean one times 1.0625 (exact in f32)."""
    return feats, feats * 1.0625


@contextlib.contextmanager
def _fixed_views(mp):
    mp.setattr(jaugment, "gaussian_noise_pair", _fixed_view)
    mp.setattr(augment, "gaussian_noise_pair", _fixed_view)
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def _jax_semi_args(argv):
    """JAX's ``cli.main_semi`` argument handling, on ``argv``."""
    parser = jtrain_lib.get_parser()
    parser.add_argument("--ema_m", type=float, default=0.9996)
    parser.add_argument("--semi_batch_size", default=64, type=int)
    parser.add_argument("--teacher_eval", action="store_false", default=True)
    args = parser.parse_args(argv)
    args.ema_decay = args.ema_m
    return args


def _write_teacher(jargs, jax_dir, torch_dir):
    """The JAX trainer's initial parameters with class ``RAISED`` favoured,
    as each package's checkpoint ``teacher``."""
    jcfg = jtrain_lib.args_to_config(jargs)
    jmodel, _ = jbuild(jcfg)
    m = jcfg.model
    v = jax.jit(lambda r: jmodel.init({"params": r, "dropout": r},
                                      jnp.zeros((1, m.max_frames, m.n_mels, 1)),
                                      jnp.zeros((1, m.max_frames), bool), True))(
        jax.random.PRNGKey(jcfg.train.seed))
    params = jax.tree.map(np.array, flax.core.unfreeze(v["params"]))  # writable copies
    frozen = jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"]))
    params["class_embed"]["bias"][RAISED] += 6.0
    params["weak_class_embed"]["bias"][RAISED] += 4.0
    jcheckpoint.save_checkpoint(str(jax_dir / "teacher"), {"params": params, "frozen": frozen})
    checkpoint.save_checkpoint(str(torch_dir / "teacher"), {"model": from_flax(params, frozen)})


def run_both(argv, tmp_path, jax_extra=(), torch_extra=()):
    """JAX's ``run_semi`` and the port's on ``argv`` from the same teacher
    checkpoint: (JAX's per-epoch loss means, pseudo counts and thresholds,
    the port's result)."""
    jargs = _jax_semi_args(argv + ["--exp_root", str(tmp_path / "jax")] + list(jax_extra))
    dirs = {side: tmp_path / side / "dcase" / "model" for side in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir(parents=True)
    _write_teacher(jargs, dirs["jax"], dirs["torch"])
    recorded = {"loss": [], "counts": [], "thresholds": []}
    real_totals = jmeters.DeviceMetricAccumulator.totals
    real_adjust = jengine.adjust_threshold

    def totals(self):
        out = real_totals(self)
        if "pseudo_counts" in out:  # an epoch's train steps, not an evaluation
            recorded["loss"].append(float(out["loss"]) / self.steps)
            recorded["counts"].append(np.asarray(out["pseudo_counts"]))
        return out

    def adjust(*a):
        out = real_adjust(*a)
        recorded["thresholds"].append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp, _fixed_views(mp):
        mp.setattr(jmeters.DeviceMetricAccumulator, "totals", totals)
        mp.setattr(jengine, "adjust_threshold", adjust)
        jtrain_lib.run_semi(jargs)
    with pytest.MonkeyPatch.context() as mp, _fixed_views(mp):
        result = train_lib.run_semi(
            cli.semi_args(argv + ["--exp_root", str(tmp_path / "torch")] + list(torch_extra)),
            device="cpu")
    return recorded, result


def assert_runs_match(want, result, steps):
    assert len(result.epochs) == len(want["loss"]) == 2
    for e, rec in enumerate(result.epochs):
        assert rec["epoch"] == e and rec["steps"] == steps
        assert {"sup_loss_ce", "unsup_loss_ce", "sup_loss_weak", "unsup_loss_giou_0"} <= set(
            rec["loss_means"])
        np.testing.assert_allclose(rec["loss"], want["loss"][e], err_msg=f"epoch {e}",
                                   **(TOL_FIRST if e == 0 else TOL))
        if e == 0:
            np.testing.assert_array_equal(rec["pseudo_counts"], want["counts"][0])
        if np.array_equal(rec["pseudo_counts"], want["counts"][e]):
            np.testing.assert_allclose(rec["thresholds"], want["thresholds"][e], rtol=0,
                                       atol=1e-6, err_msg=f"epoch {e}")
    counts = np.asarray(result.epochs[0]["pseudo_counts"])
    assert counts[RAISED] > 0 and counts.sum() == counts[RAISED], counts
    assert result.epochs[0]["thresholds"][RAISED] == 0.7  # clipped from above
    assert result.bank and [r["model"] for r in result.final] == ["teacher"]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    return (tmp,) + run_both(SMOKE, tmp)


def test_synthetic_smoke_matches_jax(smoke):
    _, want, result = smoke
    assert_runs_match(want, result, steps=4)  # 16 weak clips at 2 a batch


def test_checkpoints_hold_the_student_and_the_teacher(smoke):
    _, _, result = smoke
    best = checkpoint.load_checkpoint(f"{result.model_dir}/semi_1_best")
    assert {"model", "teacher", "epoch", "event_based_f1_1"} == set(best)
    periodic = checkpoint.load_checkpoint(f"{result.model_dir}/semi_0")
    assert {"model", "teacher", "optimizer", "epoch", "classwise_threshold", "sampler",
            "generator", "save_best", "early"} == set(periodic)
    assert periodic["optimizer"]["updates"] == 4
    assert periodic["classwise_threshold"].dtype == torch.float64
    np.testing.assert_array_equal(periodic["classwise_threshold"].numpy(),
                                  result.epochs[0]["thresholds"])
    # the teacher follows the student slowly: close, not equal
    t, s = periodic["teacher"]["class_embed.weight"], periodic["model"]["class_embed.weight"]
    assert not torch.equal(t, s) and torch.allclose(t, s, atol=1e-2)


def test_resume_reproduces_the_next_epoch(smoke):
    """From the periodic checkpoint of epoch 0 the resumed run's epoch 1
    equals the uninterrupted run's bit for bit."""
    tmp, _, result = smoke
    with pytest.MonkeyPatch.context() as mp, _fixed_views(mp):
        resumed = cli.main_semi(SMOKE + ["--exp_root", str(tmp / "torch"), "--resume", "semi_0"],
                                device="cpu")
    assert [r["epoch"] for r in resumed.epochs] == [1]
    for key in ("loss_means", "pseudo_counts", "thresholds", "val_f1", "val_loss_means"):
        assert resumed.epochs[0][key] == result.epochs[1][key], key


def test_eval_tests_the_best_teacher(smoke):
    tmp, _, result = smoke
    with pytest.MonkeyPatch.context() as mp, _fixed_views(mp):
        tested = cli.main_semi(SMOKE + ["--exp_root", str(tmp / "torch"), "--eval"],
                               device="cpu")
    assert tested.epochs == [] and tested.final[0]["model"] == "teacher"
    assert tested.final[0]["loaded"].endswith("semi_1_best")
    assert tested.f1 == result.f1


def test_semi_args():
    args = cli.semi_args([])
    assert (args.ema_decay, args.semi_batch_size, args.teacher_eval) == (0.9996, 64, True)
    assert args.info == "semi_supervised_dcase_atloss_1_atploss_1_enc_3_pooling_None_[1]"
    args = cli.semi_args(["--ema_m", "0.99", "--teacher_eval", "--info", "x"])
    assert (args.ema_decay, args.teacher_eval, args.info) == (0.99, False, "x")
    assert train_lib.args_to_config(args).train.ema_decay == 0.99
    assert cli.semi_args(["--eval", "--info", "x", "--epochs", "5"]).epochs == 0
    for argv in (["--dataname", "urbansed"], ["--eval"]):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
            cli.semi_args(argv)
    assert cli.semi_args(["--dataname", "urbansed", "--synthetic_smoke"]).dataname == "urbansed"


def test_a_dataset_needs_the_teacher_model(tmp_path):
    with pytest.raises(SystemExit, match="teacher_model"), \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main_semi(["--data_root", str(tmp_path / "none"), "--exp_root", str(tmp_path),
                       "--log"], device="cpu")


def test_several_processes_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(train_lib, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main_semi(["--synthetic_smoke", "--exp_root", str(tmp_path), "--log"], device="cpu")
