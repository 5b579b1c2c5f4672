"""Set criterion of the PyTorch port against the JAX package on the same
numpy outputs and targets (f32, rtol 1e-5).  Continuous random inputs have
a unique optimal assignment, so both sides match the same pairs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import LossConfig as JLoss
from sound_event_detection_transformer_tpu.config import ModelConfig as JModel
from sound_event_detection_transformer_tpu.models import criterion as jcrit
from sound_event_detection_transformer_tpu_torch.config import LossConfig as TLoss
from sound_event_detection_transformer_tpu_torch.config import ModelConfig as TModel
from sound_event_detection_transformer_tpu_torch.models import criterion as tcrit

torch.set_num_threads(2)

B, Q, C, M, A = 6, 10, 10, 20, 2


def _inputs(seed, pooling=False):
    rng = np.random.RandomState(seed)
    out = {
        "pred_logits": rng.randn(B, Q, C + 1).astype(np.float32),
        "pred_boxes": rng.uniform(0.05, 0.95, (B, Q, 2)).astype(np.float32),
        "at": rng.uniform(0.01, 0.99, (B, C)).astype(np.float32),
        "aux_logits": rng.randn(A, B, Q, C + 1).astype(np.float32),
        "aux_boxes": rng.uniform(0.05, 0.95, (A, B, Q, 2)).astype(np.float32),
    }
    if pooling:
        out["at_p"] = rng.uniform(0.01, 0.99, (B, C)).astype(np.float32)
    n = rng.randint(0, 6, B)
    n[0] = 0  # one sample without events
    valid = np.arange(M)[None, :] < n[:, None]
    targets = dict(
        labels=np.where(valid, rng.randint(0, C, (B, M)), 0).astype(np.int32),
        boxes=np.where(valid[..., None], rng.uniform(0.05, 0.5, (B, M, 2)), 0).astype(np.float32),
        box_valid=valid,
        label_valid=valid,
        ratio=np.where(valid, rng.uniform(0.3, 1.0, (B, M)), 1.0).astype(np.float32),
        orig_size=np.full((B,), 10.0, np.float32),
    )
    strong = n > 0
    strong[-1] = False  # a padded tail row: excluded by the eval step's valid mask
    return out, targets, strong


def _run_both(out, targets, strong, weak, mkw, fl=False, drop_aux=False):
    if drop_aux:
        out = {k: v for k, v in out.items() if not k.startswith("aux_")}
    jm = JModel(**mkw)
    tm = TModel(**mkw)
    want, _ = jcrit.set_criterion(
        {k: jnp.asarray(v) for k, v in out.items()},
        jcrit.DenseTargets(**{k: jnp.asarray(v) for k, v in targets.items()}),
        jnp.asarray(strong), None if weak is None else jnp.asarray(weak),
        jm, JLoss(), fl=fl)
    got, _ = tcrit.set_criterion(
        {k: torch.from_numpy(v) for k, v in out.items()},
        tcrit.DenseTargets(**{k: torch.from_numpy(v) for k, v in targets.items()}),
        torch.from_numpy(strong), None if weak is None else torch.from_numpy(weak),
        tm, TLoss(), fl=fl)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    return got


def test_eval_settings_match_jax():
    """The eval step's call: strong & valid, weak None, aux layers, dec_at."""
    out, targets, strong = _inputs(0)
    got = _run_both(out, targets, strong, None, dict(dec_layers=A + 1, dec_at=True))
    assert {"loss_ce_1", "loss_bbox_1", "loss_giou_1", "cardinality_error_1"} <= set(got)


@pytest.mark.parametrize("fl", [False, True], ids=["ce", "focal"])
def test_weak_pooling_and_focal_match_jax(fl):
    out, targets, strong = _inputs(1, pooling=True)
    weak = ~strong
    _run_both(out, targets, strong, weak,
              dict(dec_layers=A + 1, dec_at=True, pooling="max"), fl=fl)


def test_without_aux_layers_matches_jax():
    out, targets, strong = _inputs(2)
    _run_both(out, targets, strong, None, dict(dec_layers=A + 1, dec_at=True, aux_loss=False),
              drop_aux=True)


def test_joint_match_solves_all_layers_in_one_call(monkeypatch):
    from sound_event_detection_transformer_tpu_torch.ops import matcher as tmatcher

    calls = []
    real = tmatcher.lsap
    monkeypatch.setattr(tmatcher, "lsap", lambda c: calls.append(tuple(c.shape)) or real(c))
    out, targets, strong = _inputs(3)
    tcrit.set_criterion(
        {k: torch.from_numpy(v) for k, v in out.items()},
        tcrit.DenseTargets(**{k: torch.from_numpy(v) for k, v in targets.items()}),
        torch.from_numpy(strong), None, TModel(dec_layers=A + 1, dec_at=True), TLoss())
    assert calls == [((A + 1) * B, Q, M)]


@pytest.mark.parametrize("mkw", [
    dict(),
    dict(dec_at=True, dec_layers=3),
    dict(dec_at=True, pooling="attn", dec_layers=6),
    dict(aux_loss=False, dec_at=True),
    dict(self_sup=True, feature_recon=True),
])
def test_build_weight_dict_matches_jax(mkw):
    lkw = dict(weak_loss_coef=0.25, eos_coef=0.2)
    want = jcrit.build_weight_dict(JModel(**mkw), dataclasses.replace(JLoss(), **lkw))
    got = tcrit.build_weight_dict(TModel(**mkw), dataclasses.replace(TLoss(), **lkw))
    assert got == want
    assert list(got) == list(want)
