"""The port's SP-SEDT pretrainer, ``train_lib.run_spsedt``, against the JAX
package's, and the fine-tune that starts from its checkpoint.

* Side by side on ``--synthetic_smoke`` (16 clips of 128 x 64) and on a
  seeded DCASE layout on disk (8 clips of ``unlabel_in_domain.tsv`` at
  496 x 64, each side extracting its own ``.npy`` cache and computing its
  own scaler), from the same initial weights (the JAX trainer's
  ``init_train_state`` with ``PRNGKey(seed)``, through ``weights.from_flax``
  in place of the port's ``train_lib.init_model``), tiny model (resnet18,
  d 64, 1 encoder and 2 decoder layers, FFN 128), 20 queries from 5 patches,
  ``feature_recon``, batch 4, 2 epochs, dropout 0, f32.  Both sides run at
  ``mask_ratio`` 0.0 (every patch query kept), set through this file's own
  wrapper of each package's ``args_to_config`` (there is no flag), so the
  two packages' different random streams decide nothing.  The patch boxes
  come from numpy: the JAX trainer seeds the global stream and draws each
  epoch's permutation and then each clip's boxes from it (on disk its
  ``DataLoadDf`` would draw the boxes from an unseeded stream of its own,
  which the wrapper here points at the global one); the port draws both
  from one ``RandomState`` with the same seed, so the boxes match draw for
  draw.
* Each epoch's loss mean to the tolerances of ``test_torch_trainer``:
  epoch 0 to rtol 2e-4, epoch 1 to 5e-3.
* The port's ``--resume`` from its epoch-0 checkpoint reproduces epoch 1
  bit for bit; ``run_supervised --pretrain`` carries the port's own
  checkpoint into a DCASE fine-tune by the surgery's rules; ``run_spsedt
  --pretrain`` takes the backbone's parameters from an audio-tag checkpoint
  and keeps its own FrozenBN statistics (its parity with the JAX chain is
  ``tests/test_torch_trainer_at.py``'s); ``--extra_data`` adds
  ``dcase2018_task5.tsv``'s clips.
"""
import contextlib
import dataclasses
import io
import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.data import dataset as jdataset
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.utils import meters as jmeters
from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.models import AudioTagBackbone, build_model
from sound_event_detection_transformer_tpu_torch.utils import checkpoint
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_trainer import TOL, TOL_FIRST

torch.set_num_threads(2)
TINY = ["--batch_size", "4", "--backbone", "resnet18", "--hidden_dim", "64", "--enc_layers",
        "1", "--dec_layers", "2", "--dim_feedforward", "128", "--num_queries", "20",
        "--num_patches", "5", "--feature_recon", "--epochs", "2", "--dropout", "0",
        "--compute_dtype", "float32", "--checkpoint_epochs", "1", "--log", "--info", "pre"]
SMOKE = ["--synthetic_smoke", "--smoke_clips", "16"] + TINY


def _mask_ratio_0(args_to_config):
    def wrapped(args):
        cfg = args_to_config(args)
        return cfg.replace(model=dataclasses.replace(cfg.model, mask_ratio=0.0))
    return wrapped


def _jax_init_state(jargs):
    """The JAX trainer's initial parameters and FrozenBN statistics as a
    state_dict of the port (``run_spsedt``'s ``init_train_state``)."""
    jcfg = jtrain_lib.args_to_config(jargs)
    jmodel, _ = jbuild(jcfg)
    m = jcfg.model
    v = jax.jit(lambda r: jmodel.init(
        {"params": r, "dropout": r, "patch_mask": r}, jnp.zeros((1, m.max_frames, m.n_mels, 1)),
        jnp.zeros((1, m.max_frames), bool), jnp.zeros((1, m.num_patches, 128, 64, 1)), True))(
        jax.random.PRNGKey(jcfg.train.seed))
    return from_flax(jax.tree.map(np.asarray, flax.core.unfreeze(v["params"])),
                     jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])))


def run_both(argv, tmp_path, jax_extra=(), torch_extra=()):
    """JAX's ``run_spsedt`` and the port's on ``argv`` from the same initial
    parameters, both at mask_ratio 0: (JAX's epoch loss means, the port's
    result)."""
    jargs = jtrain_lib.get_parser().parse_args(argv + ["--exp_root", str(tmp_path / "jax")]
                                               + list(jax_extra))
    jargs.extra_data = False
    recorded = []
    real_means = jmeters.DeviceMetricAccumulator.means
    real_init = jdataset.DataLoadDf.__init__

    def means(self):
        out = real_means(self)
        recorded.append(float(out[0]["loss"]))
        return out

    def data_load_df(self, *a, **kw):  # patch boxes from numpy's seeded global stream
        real_init(self, *a, **kw)
        if self.num_patches is not None:
            self.rng = np.random

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jmeters.DeviceMetricAccumulator, "means", means)
        mp.setattr(jdataset.DataLoadDf, "__init__", data_load_df)
        mp.setattr(jtrain_lib, "args_to_config", _mask_ratio_0(jtrain_lib.args_to_config))
        jtrain_lib.run_spsedt(jargs)
    state = _jax_init_state(jargs)

    def init_model(cfg, device):
        model, wd = build_model(cfg, device=device)
        model.load_state_dict(state, strict=True)
        return model, wd

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "init_model", init_model)
        mp.setattr(train_lib, "args_to_config", _mask_ratio_0(train_lib.args_to_config))
        result = train_lib.run_spsedt(
            cli.spsedt_args(argv + ["--exp_root", str(tmp_path / "torch")] + list(torch_extra)),
            device="cpu")
    return recorded, result


def assert_runs_match(jax_means, result, steps):
    assert len(result.epochs) == len(jax_means) == 2
    for e, (rec, want) in enumerate(zip(result.epochs, jax_means)):
        assert rec["epoch"] == e and rec["steps"] == steps
        assert {"loss_feature", "loss_feature_0", "loss_ce"} <= set(rec["loss_means"])
        np.testing.assert_allclose(rec["loss"], want, err_msg=f"epoch {e}",
                                   **(TOL_FIRST if e == 0 else TOL))
    assert result.bank
    assert sorted(p.name for p in Path(result.model_dir).iterdir()) == ["pre", "pre_0", "pre_1"]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    return (tmp,) + run_both(["--dataname", "dcase"] + SMOKE, tmp)


def test_synthetic_smoke_matches_jax(smoke):
    _, jax_means, result = smoke
    assert_runs_match(jax_means, result, steps=4)  # 16 clips at batch 4


def test_resume_reproduces_the_next_epoch(smoke):
    """From the periodic checkpoint of epoch 0, the resumed run's epoch 1
    equals the uninterrupted run's bit for bit: the model, AdamW, the
    permutation and patch-box stream and the step's generator come back."""
    tmp, _, result = smoke
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "args_to_config", _mask_ratio_0(train_lib.args_to_config))
        resumed = train_lib.run_spsedt(
            cli.spsedt_args(["--dataname", "dcase"] + SMOKE + [
                "--exp_root", str(tmp / "torch"), "--resume", "pre_0"]), device="cpu")
    assert [r["epoch"] for r in resumed.epochs] == [1]
    assert resumed.epochs[0]["loss_means"] == result.epochs[1]["loss_means"]
    final = checkpoint.load_checkpoint(resumed.checkpoint)
    assert final["epoch"] == 2 and set(final) == {"model", "epoch"}
    assert checkpoint.load_checkpoint(f"{result.model_dir}/pre_0")["optimizer"]["updates"] == 4


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disk")
    src = tmp / "written"
    wav_dataset.write_dcase(str(src), strong=4, weak=4, unlabel=8, validate=4, test=4, seed=3)
    roots = {side: tmp / f"data_{side}" for side in ("jax", "torch")}
    for root in roots.values():
        shutil.copytree(src, root)
    run = run_both(["--dataname", "dcase"] + TINY, tmp,
                   jax_extra=["--data_root", str(roots["jax"])],
                   torch_extra=["--data_root", str(roots["torch"])])
    return (tmp, roots["torch"]) + run


def test_dcase_unlabel_on_disk_matches_jax(disk):
    _, _, jax_means, result = disk
    assert_runs_match(jax_means, result, steps=2)  # 8 clips at batch 4
    t = result.data_timings
    assert t["extracted"] == t["clips"] == 8 and t["scaler_s"] >= 0


def test_supervised_pretrain_loads_the_checkpoint_by_the_rules(disk):
    """``run_supervised --dec_at --pretrain pre`` on the same layout and
    ``exp_root``: right after the ImageNet init every parameter the
    surgery loads equals the checkpoint's (query rows 1: for the 20
    pretrained ones), the class heads and query row 0 keep their init, and
    the FrozenBN buffers are untouched; then the run trains."""
    tmp, root, _, result = disk
    pre = checkpoint.load_checkpoint(result.checkpoint)["model"]
    seen = {}
    real = train_lib.load_pretrain_into

    def spy(model, state):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = real(model, state)
        seen.update(before=before, after={k: v.clone() for k, v in model.state_dict().items()},
                    loaded=loaded, buffers={n for n, _ in model.named_buffers()})
        return loaded

    argv = ["--dataname", "dcase", "--data_root", str(root), "--exp_root", str(tmp / "torch"),
            "--batch_size", "4", "--n_weak", "2", "--backbone", "resnet18", "--hidden_dim", "64",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward", "128", "--epochs",
            "1", "--dropout", "0", "--compute_dtype", "float32", "--dec_at", "--log",
            "--pretrain", "pre"]
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "load_pretrain_into", spy)
        tresult = cli.main_sedt(argv, device="cpu")
    before, after, loaded = seen["before"], seen["after"], set(seen["loaded"])
    assert after["query_embed.weight"].shape[0] == pre["query_embed.weight"].shape[0] + 1 == 21
    assert torch.equal(after["query_embed.weight"][1:], pre["query_embed.weight"])
    assert torch.equal(after["query_embed.weight"][0], before["query_embed.weight"][0])
    for name, value in after.items():
        if name in seen["buffers"] or "class_embed" in name:
            assert name not in loaded and torch.equal(value, before[name]), name
        elif name != "query_embed.weight":
            assert name in loaded and torch.equal(value, pre[name]), name
    assert np.isfinite(tresult.epochs[0]["loss"])
    assert cli.sedt_args(argv).info.endswith("_pre")


def test_extra_data_adds_the_2018_task5_clips(disk, tmp_path):
    """``--extra_data`` reads ``metadata/train/dcase2018_task5.tsv`` (its
    audio under ``audio/train/dcase2018_task5``) after the unlabeled TSV."""
    _, root, _, _ = disk
    data = tmp_path / "data"
    shutil.copytree(root, data)
    dc = data / "dcase"
    src = dc / "audio" / "train" / "unlabel_in_domain"
    dst = dc / "audio" / "train" / "dcase2018_task5"
    dst.mkdir(parents=True)
    names = sorted(p.name for p in src.iterdir())[:4]
    for n in names:
        shutil.copy(src / n, dst / f"task5_{n}")
    (dc / "metadata" / "train" / "dcase2018_task5.tsv").write_text(
        "filename\n" + "".join(f"task5_{n}\n" for n in names))
    argv = (["--dataname", "dcase", "--data_root", str(data), "--exp_root", str(tmp_path / "exp"),
             "--extra_data"] + TINY + ["--epochs", "1", "--checkpoint_epochs", "0"])
    with contextlib.redirect_stdout(io.StringIO()):
        result = cli.main_spsedt(argv, device="cpu")
    assert result.data_timings["clips"] == 12 and result.epochs[0]["steps"] == 3
    assert np.isfinite(result.epochs[0]["loss"])


def test_spsedt_pretrain_loads_the_audio_tag_backbone(tmp_path):
    """``--pretrain at`` after the ImageNet init: every backbone parameter
    takes the audio-tag checkpoint's value (written here with other
    FrozenBN statistics and a head), the FrozenBN buffers stay the model's,
    nothing else of the model changes, and the run trains."""
    torch.manual_seed(7)  # other parameters than the SP-SEDT's init
    at = AudioTagBackbone("resnet18", num_classes=10)
    with torch.no_grad():
        for b in at.buffers():
            b.add_(0.25)  # other statistics than the SP-SEDT's
    model_dir = tmp_path / "exp" / "dcase" / "model"
    checkpoint.save_checkpoint(str(model_dir / "at"), {"model": at.state_dict(), "epoch": 3})
    seen = {}
    real = train_lib.load_audio_tag_backbone

    def spy(model, state):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = real(model, state)
        seen.update(before=before, after={k: v.clone() for k, v in model.state_dict().items()},
                    loaded=loaded, buffers={n for n, _ in model.named_buffers()})
        return loaded

    argv = ["--dataname", "dcase"] + SMOKE + ["--exp_root", str(tmp_path / "exp"), "--epochs",
                                              "1", "--pretrain", "at"]
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(train_lib, "load_audio_tag_backbone", spy)
        result = cli.main_spsedt(argv, device="cpu")
    src = at.state_dict()
    before, after = seen["before"], seen["after"]
    backbone = {n for n in after if n.startswith("backbone.") and n not in seen["buffers"]}
    assert set(seen["loaded"]) == backbone and len(backbone) == 22
    for name, value in after.items():
        if name in backbone:
            assert torch.equal(value, src[name]) and not torch.equal(value, before[name]), name
        else:
            assert torch.equal(value, before[name]), name
    for name in seen["buffers"]:
        assert not torch.equal(after[name], src[name]), name
    assert not any(n.startswith(("fc1", "fc2")) for n in after)
    assert np.isfinite(result.epochs[0]["loss"])


def test_default_info_and_the_dataset_check():
    assert cli.spsedt_args(["--enc_layers", "6", "--feature_recon"]).info == \
        "pretrain_enc_6_feature_recon"
    assert cli.spsedt_args(["--fixed_patch_size"]).info == "pretrain_enc_3_fixed_patch_size"
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.spsedt_args(["--dataname", "urbansed"])
