"""The port's supervised trainer on a dataset on disk against the JAX
package's: ``run_supervised`` on URBAN-SED ``.npy`` features (2 epochs, the
fine-tune stage in the second), on URBAN-SED with ``--from_wavs`` (the
frontend inside the train step), and on DCASE ``.npy`` with a weak and a
strong stream and an ImageNet backbone found at ``<data_root>/resnet18.pth``.

Each run writes a seeded dataset with the port's writer and gives each side
its own copy, so each extracts its own features and computes and saves its
own scaler in a fresh ``exp_root``.  Both sides start from the JAX trainer's
initial parameters (``test_torch_trainer.run_both``).  Tiny model (resnet18,
d 64, 1+1 layers, FFN 128) at the datasets' real clip length (URBAN-SED
500 x 64, DCASE 496 x 64), batch 4, dropout 0, f32.  The fine-tune stage's
relaxed matching keeps each extra query with probability ``alpha * num_gt /
num_queries``; ``--alpha 100`` makes that 1 wherever a clip has an event, so
the two packages' different random streams decide nothing.

Tolerances are PR 6's (``test_torch_trainer``): epoch 0's loss means to
rtol 2e-4, later epochs' to 5e-3.  The features of the two sides differ by
1e-6 relative (``test_torch_disk_data``), far below both.
"""
import shutil

import numpy as np
import torch

from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.models.torch_import import torchvision_resnet_shapes
from test_torch_trainer import TOL, TOL_FIRST, run_both

torch.set_num_threads(2)
TINY = ["--batch_size", "4", "--backbone", "resnet18", "--hidden_dim", "64", "--enc_layers",
        "1", "--dec_layers", "1", "--dim_feedforward", "128", "--epochs", "2", "--dropout", "0",
        "--compute_dtype", "float32", "--dec_at", "--fusion_strategy", "1", "2", "--log",
        "--info", "tiny", "--alpha", "100"]


def write(root, dataname):
    if dataname == "urbansed":
        wav_dataset.write_urbansed(str(root), train=8, validate=4, test=4, seed=3)
    else:
        wav_dataset.write_dcase(str(root), strong=4, weak=4, unlabel=0, validate=4, test=4,
                                seed=3)


def seeded_resnet18(path):
    rng = np.random.RandomState(1)
    torch.save({k: torch.from_numpy((rng.rand(*s) + 0.5 if k.endswith("running_var")
                                     else rng.randn(*s) * 0.05).astype(np.float32))
                for k, s in torchvision_resnet_shapes("resnet18").items()
                if not k.endswith("num_batches_tracked")}, path)


def run_disk(tmp_path, dataname, extra, imagenet=False):
    src = tmp_path / "written"
    write(src, dataname)
    if imagenet:
        seeded_resnet18(src / "resnet18.pth")
    roots = {side: tmp_path / f"data_{side}" for side in ("jax", "torch")}
    for root in roots.values():
        shutil.copytree(src, root)
    argv = ["--dataname", dataname] + TINY + extra
    return run_both(argv, tmp_path, jax_extra=["--data_root", str(roots["jax"])],
                    torch_extra=["--data_root", str(roots["torch"])])


def assert_matches(run, steps, fine_tune_from=None):
    jtrain, jval, jresult, tresult, jdir, tdir = run
    epochs = tresult.epochs
    assert len(epochs) == len(jtrain) == len(jval) == 2
    for e, (rec, jt, jv) in enumerate(zip(epochs, jtrain, jval)):
        tol = TOL_FIRST if e == 0 else TOL
        ft = fine_tune_from is not None and e >= fine_tune_from
        assert rec["steps"] == steps and rec["fine_tune"] == ft
        assert rec["lr"] == (1e-5 if ft else 1e-4)
        assert rec["loss_means"].keys() == jt.keys() and rec["val_loss_means"].keys() == jv.keys()
        for k, w in jt.items():
            np.testing.assert_allclose(rec["loss_means"][k], w, err_msg=f"epoch {e} {k}", **tol)
        for k, w in jv.items():
            np.testing.assert_allclose(rec["val_loss_means"][k], w, err_msg=f"val {e} {k}",
                                       **tol)
        assert np.isfinite(rec["loss"]) and rec["data_wait_s"] >= 0
    assert tresult.f1.keys() == jresult.keys() == {2}
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    assert (tdir.parent.parent / f"{tdir.parent.name}.json").is_file()  # the saved scaler
    t = tresult.data_timings
    assert t["extracted"] == t["clips"] > 0


def test_urbansed_npy_with_fine_tune(tmp_path):
    run = run_disk(tmp_path, "urbansed", ["--epochs_ls", "1"])
    assert_matches(run, steps=2, fine_tune_from=1)
    tresult = run[3]
    assert tresult.bank and tresult.epochs[1]["fine_tune"]


def test_urbansed_from_wavs(tmp_path, monkeypatch):
    """The train batches come from a ``WavLoadDf`` (waveforms) with no bank;
    validation and eval read ``.npy`` from their banks."""
    shapes = []
    real = train_lib.train_one_epoch

    def spy(train_step, dataset, sampler, cfg, bank, generator, log):
        shapes.append((type(dataset.datasets[0]).__name__, bank))
        return real(train_step, dataset, sampler, cfg, bank, generator, log)

    monkeypatch.setattr(train_lib, "train_one_epoch", spy)
    run = run_disk(tmp_path, "urbansed", ["--epochs_ls", "10", "--from_wavs"])
    assert_matches(run, steps=2)
    assert shapes == [("WavLoadDf", None)] * 2
    assert not run[3].bank


def test_dcase_npy_with_imagenet_backbone(tmp_path):
    """Two streams (2 strong and 2 weak clips a batch) and the auto path of
    the ImageNet backbone on both sides."""
    run = run_disk(tmp_path, "dcase", ["--epochs_ls", "10", "--n_weak", "2"], imagenet=True)
    assert_matches(run, steps=2)
    assert "loss_weak" in run[3].epochs[0]["loss_means"]
