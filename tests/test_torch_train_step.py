"""One supervised train step of the PyTorch port against one call of the JAX
package's ``make_train_step``, on the same weights (``weights.from_flax`` of
one JAX init, FrozenBN statistics drawn with numpy) and the same
``SyntheticDataset`` batch, f32 at the tiny test geometry.  Dropout is 0 on
the ``deterministic=False`` path, since the two packages' random streams
differ.  Three kinds of step: plain matching, ``fine_tune`` (with ``alpha``
large enough that the relaxed stage keeps every candidate, so no draw
decides anything) and ``normalize``.

The JAX step's gradients are read through a first optax transformation that
keeps them in its state; the port's come from the same loss function that
its step runs (``engine.make_loss_fn``), since the step zeroes them after the
update.

Tolerances (f32 on both sides):

* losses atol 1e-4, rtol 1e-4 (f32 sums in another order);
* gradients leaf by leaf: rtol 1e-3, and atol 1e-2 of the leaf's largest
  entry plus 2e-4 of the largest entry of any leaf.  The atol is set by the
  JAX package's side: against a float64 run of the port, JAX's CPU f32
  gradients differ by up to 4e-3 of a leaf's largest entry (decoder layer 0,
  whose target input is all zeros) and by up to 2e-4 absolute in leaves whose
  gradient is small (the decoder's cross-attention queries and keys, where
  the softmax over near-uniform scores cancels), while the port's f32
  gradients differ from it by about 1e-6 of a leaf's largest entry;
* updated parameters atol 2e-8 (a fifth of a percent of the lr, 1e-4) and
  rtol 2.5e-7 (two f32 roundings of the parameter), on the entries that the
  gradients pin.  Adam's first update is lr * g / (|g| + eps), about
  lr * sign(g), so an entry is masked where its JAX gradient is below 1e-6 of
  its leaf's largest (and not exactly 0 on both sides, as in the dead units
  of the tiny backbone, where weight decay alone moves it), where the two
  gradients differ in sign, or where their first Adam steps differ by more
  than 1e-4 (eps taken before the clip).  A
  gradient at rounding-noise level may move its entry the other way, so the
  masked entries (under a tenth of them) are held only to Adam's bound,
  2 lr (1 + wd |p|);
* frozen parameters and FrozenBN buffers bit for bit.
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.data import dataset as jdataset
from sound_event_detection_transformer_tpu.data.encoder import BoxEncoder as JEncoder
from sound_event_detection_transformer_tpu.data.synthetic import SyntheticDataset as JSynthetic
from sound_event_detection_transformer_tpu.engine import TrainState as JTrainState
from sound_event_detection_transformer_tpu.engine import make_train_step as jmake_train_step
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.parallel.optim import make_optimizer as jmake_optimizer
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.data import dataset as tdataset
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder as TEncoder
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from sound_event_detection_transformer_tpu_torch.engine import (
    init_train_state,
    make_loss_fn,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import build_model as tbuild
from sound_event_detection_transformer_tpu_torch.ops.frontend import make_frontend_fn
from sound_event_detection_transformer_tpu_torch.parallel.optim import param_label
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, SECONDS, STEPS_PER_EPOCH = 4, 10.0, 10
KINDS = {"plain": {}, "fine_tune": {"fine_tune": True}, "normalize": {"normalize": True}}


def _configs(cfg_cls):
    """The tiny config without dropout; the fine-tune stage's epsilon keeps
    some Hungarian pairs and rejects others, and alpha 100 keeps every
    reserved extra query (keep_prob = 100 * num_gt / Q >= 1)."""
    cfg = cfg_cls.tiny_test()
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                       loss=dataclasses.replace(cfg.loss, epsilon=1.0, alpha=100.0))


def _random_frozen(frozen, rng):
    """FrozenBN statistics away from the identity (see test_torch_model.py)."""
    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.2, 0.5, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, frozen)


def _keep_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module")
def weights_and_batch():
    jcfg = _configs(JConfig)
    m = jcfg.model
    classes = jcfg.data.classes
    jds = JSynthetic(B, classes, m.max_frames, m.n_mels, JEncoder(classes, SECONDS).encode_strong_df,
                     max_events=4, seed=5)
    jbatch = jdataset.collate([jds[i] for i in range(B)], m.max_events, SECONDS)
    jmodel, _ = jbuild(jcfg)
    v = jax.jit(lambda r: jmodel.init({"params": r}, jnp.asarray(jbatch.feats),
                                      jnp.asarray(jbatch.pad_mask), True))(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])),
                            np.random.RandomState(3))
    return params, frozen, jbatch


def _port_model(params, frozen):
    tcfg = _configs(TConfig)
    model, wd = tbuild(tcfg, device="cpu")
    model.load_state_dict(from_flax(params, frozen), strict=True)
    return tcfg, model, wd


def _port_batch(tcfg):
    m = tcfg.model
    classes = tcfg.data.classes
    tds = TSynthetic(B, classes, m.max_frames, m.n_mels, TEncoder(classes, SECONDS).encode_strong_df,
                     max_events=4, seed=5)
    return tdataset.collate([tds[i] for i in range(B)], m.max_events, SECONDS)


@pytest.fixture(scope="module", params=list(KINDS))
def both(request, weights_and_batch):
    """One step of each package, of the kind ``request.param``."""
    kind = KINDS[request.param]
    params, frozen, jbatch = weights_and_batch

    jcfg = _configs(JConfig)
    jmodel, jwd = jbuild(jcfg)
    tx = optax.chain(_keep_grads(), jmake_optimizer(params, jcfg.train, STEPS_PER_EPOCH))
    jparams = jax.tree.map(jnp.asarray, params)
    state = JTrainState(jparams, jax.tree.map(jnp.asarray, frozen), tx.init(jparams),
                        jnp.asarray(0))
    jstep = jmake_train_step(jmodel, jwd, jcfg, tx, **kind)
    new_state, jmetrics = jstep(
        state, jax.tree.map(lambda x: None if x is None else jnp.asarray(x), jbatch),
        jax.random.PRNGKey(0))
    want = {
        "metrics": {k: np.asarray(v) for k, v in jmetrics.items()},
        "grads": from_flax(jax.tree.map(np.asarray, new_state.opt_state[0]), {}),
        "params": from_flax(jax.tree.map(np.asarray, new_state.params), frozen),
    }

    tcfg, model, twd = _port_model(params, frozen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstate = init_train_state(model, tcfg, STEPS_PER_EPOCH)
    tbatch = _port_batch(tcfg)
    loss, _ = make_loss_fn(model, twd, tcfg, **kind)(
        tbatch.feats, tbatch.pad_mask, tbatch.targets, tbatch.strong, tbatch.weak,
        torch.Generator().manual_seed(0))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    tstate.optimizer.adamw.zero_grad(set_to_none=False)
    step = make_train_step(model, twd, tcfg, tstate.optimizer, device="cpu", **kind)
    metrics = step(tbatch, torch.Generator().manual_seed(0))
    got = {"metrics": metrics, "grads": grads, "params": model.state_dict(), "before": before,
           "frozen": {n for n, p in model.named_parameters() if not p.requires_grad},
           "buffers": {n for n, _ in model.named_buffers()}}
    return request.param, want, got


def test_losses_match_jax(both):
    _, want, got = both
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), w, err_msg=k, **TOL)


def _grad_atol(want_grads) -> dict:
    """The gradient check's atol for each trainable leaf (module docstring)."""
    top = max(float(w.abs().max()) for w in want_grads.values())
    return {n: 1e-2 * float(w.abs().max()) + 2e-4 * top for n, w in want_grads.items()
            if param_label(n) != "frozen"}


def test_gradients_match_jax_leaf_by_leaf(both):
    """Every trainable leaf's gradient; the frozen ones have none on the
    port's side and are exactly zero on JAX's."""
    _, want, got = both
    atol = _grad_atol(want["grads"])
    for name, w in want["grads"].items():
        if param_label(name) == "frozen":
            assert name not in got["grads"] and not w.any(), name
            continue
        np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=atol[name], err_msg=name)
    assert set(got["grads"]) == set(atol)


def test_updated_params_match_jax(both):
    """The AdamW update after the clip, on the entries that the two
    gradients pin; the others within Adam's bound (module docstring)."""
    _, want, got = both
    tcfg = TConfig.tiny_test().train
    lr, wd = tcfg.lr, tcfg.weight_decay
    trainable = [n for n in want["grads"] if param_label(n) != "frozen"]
    norm = float(np.sqrt(sum((want["grads"][n].numpy().astype(np.float64) ** 2).sum()
                             for n in trainable)))
    eps = 1e-8 / min(1.0, tcfg.clip_max_norm / norm)  # Adam's eps before the clip
    n_live = n_all = 0
    for name in trainable:
        g, g_got = want["grads"][name].numpy(), got["grads"][name].numpy()
        w, p = want["params"][name].numpy(), got["params"][name].numpy()
        apart = eps * np.abs(g_got - g) / ((np.abs(g) + eps) * (np.abs(g_got) + eps))
        both_zero = (g == 0) & (g_got == 0)  # dead units: weight decay alone
        live = (((np.abs(g) >= 1e-6 * np.abs(g).max()) | both_zero)
                & (np.sign(g) == np.sign(g_got)) & (apart <= 1e-4))
        np.testing.assert_allclose(p[live], w[live], rtol=2.5e-7, atol=2e-8, err_msg=name)
        bound = 2 * lr * (1 + wd * np.abs(got["before"][name].numpy())) + 1e-7
        assert (np.abs(p - w) <= bound).all(), name
        n_live += int(live.sum())
        n_all += live.size
    assert n_live > 0.9 * n_all, (n_live, n_all)


def test_frozen_params_and_buffers_unchanged(both):
    _, _, got = both
    frozen, buffers = got["frozen"], got["buffers"]
    assert frozen and all(param_label(n) == "frozen" for n in frozen) and buffers
    for name in frozen | buffers:
        assert torch.equal(got["params"][name], got["before"][name]), name


def test_trainable_params_moved(both):
    _, _, got = both
    moved = [n for n, p in got["params"].items()
             if n not in got["frozen"] and not torch.equal(p, got["before"][n])]
    assert any(n.startswith("backbone.conv0") for n in moved)
    assert any(n.startswith("transformer.") for n in moved)


def test_step_on_waveforms_equals_step_on_their_features(weights_and_batch):
    """``frontend_fn`` inside the step gives the step on the features it makes."""
    params, frozen, _ = weights_and_batch
    tcfg = _configs(TConfig)
    fc, m = tcfg.features, tcfg.model
    n = int(fc.max_len_seconds * fc.sample_rate)
    waves = torch.from_numpy(np.random.RandomState(7).randn(B, n).astype(np.float32) * 0.1)
    frontend = make_frontend_fn(sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window,
                                hop=fc.hop_size, n_mels=fc.n_mels, max_frames=m.max_frames)
    batch = _port_batch(tcfg)
    results = []
    for fn, feats in ((frontend, waves), (None, frontend(waves))):
        _, model, wd = _port_model(params, frozen)
        state = init_train_state(model, tcfg, STEPS_PER_EPOCH)
        step = make_train_step(model, wd, tcfg, state.optimizer, frontend_fn=fn, device="cpu")
        metrics = step(batch._replace(feats=feats), torch.Generator().manual_seed(0))
        results.append((metrics, model.state_dict()))
    (m1, p1), (m2, p2) = results
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=0, atol=0)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=0)
