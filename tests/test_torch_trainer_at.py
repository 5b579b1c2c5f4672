"""The port's audio-tag trainer, ``train_lib.run_audio_tag``, against the JAX
package's, and SP-SEDT's ``--pretrain`` from its checkpoint.

* Side by side on ``--synthetic_smoke`` (DCASE classes, 16 clips of 128 x
  64 at batch 4, 16 validation clips) and on seeded layouts on disk written
  by ``data/wav_dataset.py``: DCASE (4 weak + 4 synthetic training clips, 4
  validation clips, 496 x 64) and URBAN-SED (6 training, 4 validation
  clips, 500 x 64, max pooling), both at batch 3, so the ragged tail of the
  training split is dropped and validation ends in a batch of one; each
  side extracts its own ``.npy`` cache and computes its own scaler.  Both
  sides start from the same parameters: the JAX trainer's own (its
  ``PRNGKey(seed)`` init, caught where it calls ``_imagenet_backbone_init``)
  go to the port through ``weights.from_flax`` in place of
  ``train_lib.init_audio_tag_model``.  resnet18, 2 epochs, at the
  parser's default ``--compute_dtype bfloat16``, which neither audio-tag
  trainer reads: both compute in f32.
* Each epoch's loss mean to the tolerances of ``test_torch_trainer``:
  epoch 0 to rtol 2e-4, epoch 1 to 5e-3.  Each epoch's clip macro F1 on
  validation is the same (and in every run one is not 0: measured, the
  validation logits lie 0.015 or more from the threshold, against the
  packages' differences of about 1e-4), the best checkpoint has the same
  name, and the scaler saved at ``<exp_root>/<dataset>_at.json`` the same
  values to 1e-6.
* The chain: JAX's ``run_spsedt --pretrain at_avg_dcase`` from the JAX
  audio-tag checkpoint, the port's from the port's, on ``--synthetic_smoke``
  at mask ratio 0 (``test_torch_trainer_spsedt.run_both``), give the same
  epoch losses to the same tolerances.
* ``at_args`` sets what the JAX package's ``main_at`` sets; several
  processes raise, naming the multi-GPU item; a non-finite epoch mean
  exits with code 1.  That the entry point needs a device or a GPU is
  ``tests/test_torch_package.py``'s.
"""
import contextlib
import io
import json
import os
import shutil
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu import cli as jcli
from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.utils import meters as jmeters
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.models import AudioTagBackbone
from sound_event_detection_transformer_tpu_torch.utils import checkpoint
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_trainer import TOL, TOL_FIRST
from test_torch_trainer_spsedt import SMOKE as SPSEDT_SMOKE
from test_torch_trainer_spsedt import run_both as run_spsedt_both

torch.set_num_threads(2)
TINY = ["--backbone", "resnet18", "--epochs", "2", "--log"]
SMOKE = ["--dataname", "dcase", "--synthetic_smoke", "--smoke_clips", "16", "--batch_size",
         "4"] + TINY


def run_both(argv, tmp_path, jax_extra=(), torch_extra=()):
    """JAX's ``run_audio_tag`` and the port's on ``argv`` from the same
    initial parameters: (JAX's epoch loss means, JAX's F1 of each epoch, the
    port's result)."""
    jargs = jtrain_lib.get_parser().parse_args(argv + ["--exp_root", str(tmp_path / "jax")]
                                               + list(jax_extra))
    recorded, f1s, init = [], [], {}
    real_means = jmeters.DeviceMetricAccumulator.means
    real_init = jtrain_lib._imagenet_backbone_init
    real_tagging = jtrain_lib.audio_tagging_results

    def means(self):
        out = real_means(self)
        recorded.append(float(out[0]["loss"]))
        return out

    def imagenet_init(params, frozen, args, log):  # the trainer's initial weights
        params, frozen = real_init(params, frozen, args, log)
        init["state"] = from_flax(jax.tree.map(np.asarray, flax.core.unfreeze(params)),
                                  jax.tree.map(np.asarray, flax.core.unfreeze(frozen)))
        return params, frozen

    def tagging(ref, est):
        out = real_tagging(ref, est)
        f1s.append(float(out.loc["avg", "f"]))
        return out

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jmeters.DeviceMetricAccumulator, "means", means)
        mp.setattr(jtrain_lib, "_imagenet_backbone_init", imagenet_init)
        mp.setattr(jtrain_lib, "audio_tagging_results", tagging)
        jf1 = jtrain_lib.run_audio_tag(jargs)
    assert f1s[-1] == jf1

    def init_audio_tag_model(cfg, pooling, device):
        model = AudioTagBackbone(cfg.model.backbone, cfg.model.dilation, pooling,
                                 len(cfg.data.classes), logits_out=True)
        model.load_state_dict(init["state"], strict=True)
        return model.to(device).eval()

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "init_audio_tag_model", init_audio_tag_model)
        result = cli.main_at(argv + ["--exp_root", str(tmp_path / "torch")] + list(torch_extra),
                             device="cpu")
    return recorded, f1s, result


def assert_runs_match(tmp_path, run, steps, name):
    jax_means, jax_f1s, result = run
    assert len(result.epochs) == len(jax_means) == 2
    for e, (rec, want) in enumerate(zip(result.epochs, jax_means)):
        assert rec["epoch"] == e and rec["steps"] == steps
        np.testing.assert_allclose(rec["loss"], want, err_msg=f"epoch {e}",
                                   **(TOL_FIRST if e == 0 else TOL))
    assert [rec["f1"] for rec in result.epochs] == jax_f1s and max(jax_f1s) > 0
    assert result.f1 == jax_f1s[-1]
    dataname = name.split("_")[-1]
    jdir = tmp_path / "jax" / dataname / "model"
    assert sorted(os.listdir(result.model_dir)) == sorted(os.listdir(jdir)) == [name]
    ck = checkpoint.load_checkpoint(result.checkpoint)
    assert set(ck) == {"model", "epoch"} and result.checkpoint.endswith(name)
    assert set(ck["model"]) == set(AudioTagBackbone("resnet18").state_dict())


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    return tmp, run_both(SMOKE, tmp)


def test_synthetic_smoke_matches_jax(smoke):
    tmp, run = smoke
    assert_runs_match(tmp, run, steps=4, name="at_avg_dcase")  # 16 clips at batch 4
    assert run[2].data_timings == {}


def _disk_run(tmp, write, argv):
    src = tmp / "written"
    write(str(src))
    roots = {side: tmp / f"data_{side}" for side in ("jax", "torch")}
    for root in roots.values():
        shutil.copytree(src, root)
    return run_both(argv + ["--batch_size", "3"] + TINY, tmp,
                    jax_extra=["--data_root", str(roots["jax"])],
                    torch_extra=["--data_root", str(roots["torch"])])


def _assert_scalers_match(tmp, dataname):
    files = [tmp / side / f"{dataname}_at.json" for side in ("jax", "torch")]
    want, got = (json.loads(f.read_text()) for f in files)
    assert set(want) == set(got) == {"mean_", "mean_of_square_"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_dcase_layout_on_disk_matches_jax(tmp_path):
    """Weak then synthetic training clips (8 at batch 3: 2 steps), the
    validation TSV's clips at batch 3 (the last batch holds one)."""
    run = _disk_run(tmp_path, lambda root: wav_dataset.write_dcase(
        root, strong=4, weak=4, unlabel=0, validate=4, test=4, seed=3), ["--dataname", "dcase"])
    assert_runs_match(tmp_path, run, steps=2, name="at_avg_dcase")
    _assert_scalers_match(tmp_path, "dcase")
    t = run[2].data_timings
    assert t["extracted"] == t["clips"] == 12 and t["scaler_s"] >= 0


def test_urbansed_layout_on_disk_matches_jax(tmp_path):
    run = _disk_run(tmp_path, lambda root: wav_dataset.write_urbansed(
        root, train=6, validate=4, test=2, seed=5),
        ["--dataname", "urbansed", "--pooling", "max"])
    assert_runs_match(tmp_path, run, steps=2, name="at_max_urbansed")
    _assert_scalers_match(tmp_path, "urbansed")
    assert run[2].data_timings["extracted"] == 10  # the test split is not read


def test_spsedt_pretrain_from_the_port_checkpoint_matches_jax_chain(smoke):
    """The SP-SEDT stage of the chain from each side's own audio-tag
    checkpoint (``smoke``'s, in the same ``exp_root``)."""
    tmp, _ = smoke
    loaded = []
    real = train_lib.load_audio_tag_backbone
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_lib, "load_audio_tag_backbone",
                   lambda model, state: loaded.extend(real(model, state)) or loaded)
        jax_means, result = run_spsedt_both(["--dataname", "dcase"] + SPSEDT_SMOKE
                                            + ["--pretrain", "at_avg_dcase"], tmp)
    assert len(loaded) == 22  # resnet18's convolutions and conv0's bias
    assert len(result.epochs) == len(jax_means) == 2
    for e, (rec, want) in enumerate(zip(result.epochs, jax_means)):
        np.testing.assert_allclose(rec["loss"], want, err_msg=f"epoch {e}",
                                   **(TOL_FIRST if e == 0 else TOL))


def test_at_args_set_what_the_jax_entry_point_sets(monkeypatch):
    argv = ["--dataname", "urbansed", "--nepochs", "7", "--fix_backbone"]
    seen = []
    monkeypatch.setattr(jcli, "run_audio_tag", seen.append)
    monkeypatch.setattr(sys, "argv", ["train_at.py"] + argv)
    jcli.main_at()
    targs = cli.at_args(argv)
    assert vars(targs) == vars(seen[0])
    assert (targs.epochs, targs.pooling, targs.info, targs.fix_backbone) == (
        7, "avg", "at_avg_urbansed", True)
    args = cli.at_args(["--pooling", "max"])
    assert (args.epochs, args.info, args.fix_backbone) == (400, "at_max_dcase", False)


def test_several_processes_raise_naming_multi_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(train_lib, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main_at(SMOKE + ["--exp_root", str(tmp_path / "exp")], device="cpu")
    assert not (tmp_path / "exp").exists()


def test_a_non_finite_loss_exits_with_code_1(tmp_path, monkeypatch):
    real = train_lib.make_audio_tag_step

    def nan_step(model, optimizer):
        step = real(model, optimizer)
        return lambda x, y: step(x, y) * float("nan")

    monkeypatch.setattr(train_lib, "make_audio_tag_step", nan_step)
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(io.StringIO()):
        cli.main_at(SMOKE + ["--exp_root", str(tmp_path / "exp")], device="cpu")
    assert exc.value.code == 1
    assert not os.listdir(tmp_path / "exp" / "dcase" / "model")  # no validation, no checkpoint

