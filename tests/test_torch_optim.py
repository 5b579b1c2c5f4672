"""The optimizer of the PyTorch port (``parallel/optim.py``) against the JAX
package's, on identical gradients: the labels of the freeze policy, the
schedules, three updates of clip + two-group AdamW (clip active and
inactive, ``fixed_lr``, accumulation over 2 steps, frozen leaves untouched)
and the EMA.

The parameter tree is a small stand-in with the names of the flagship's
groups (``backbone.conv0``, the frozen ``conv1`` and ``layer1``, ``layer2``,
the transformer, a head), so the labels decide what each leaf gets.
Tolerances: schedules rtol 1e-6, atol 1e-9 (the JAX package computes in f32,
and its cosine cancels near the end); parameters after
each update rtol 1e-6, atol 1e-9 (the same f32 arithmetic in another order,
on updates of about the lr, 1e-4); the EMA rtol 1e-6.
"""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.config import TrainConfig as JTrain
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.parallel import optim as jopt
from sound_event_detection_transformer_tpu_torch.config import TrainConfig as TTrain
from sound_event_detection_transformer_tpu_torch.parallel import optim as topt
from sound_event_detection_transformer_tpu_torch.weights import _leaves, _param, from_flax

torch.set_num_threads(2)

SHAPES = {
    "backbone": {"conv0": {"kernel": (1, 1, 1, 3), "bias": (3,)},
                 "conv1": {"kernel": (7, 7, 3, 4)},
                 "layer1_0": {"conv1": {"kernel": (3, 3, 4, 4)}},
                 "layer2_0": {"conv1": {"kernel": (3, 3, 4, 8)},
                              "downsample_conv": {"kernel": (1, 1, 4, 8)}}},
    "transformer": {"encoder_layer_0": {"ffn": {"linear1": {"kernel": (8, 16), "bias": (16,)}},
                                        "norm1": {"scale": (8,), "bias": (8,)}}},
    "class_embed": {"kernel": (8, 5), "bias": (5,)},
}


def _tree(rng, scale=1.0):
    return jax.tree.map(lambda s: (rng.randn(*s) * scale).astype(np.float32), SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))


def _module(state):
    """An nn.Module whose parameters carry the names of ``state``."""
    root = torch.nn.Module()
    for name, value in state.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(leaf, torch.nn.Parameter(value.clone()))
    return root


def _jax_frozen_zero(grads):
    """The JAX step's frozen leaves get exact zeros (``_swap_in_frozen``)."""
    labels = jopt.label_tree(grads)
    return jax.tree.map(lambda g, l: np.zeros_like(g) if l == "frozen" else g, grads, labels)


def test_labels_match_jax_on_the_tiny_model():
    jcfg = JConfig.tiny_test()
    model, _ = jbuild(jcfg)
    m = jcfg.model
    v = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, m.max_frames, m.n_mels, 1)),
                                          jnp.zeros((1, m.max_frames), bool), True))
    params = flax.core.unfreeze(v["params"])
    seen = {}
    for path, leaf in _leaves(params):
        name, _ = _param(path, np.zeros(leaf.shape, np.float32))
        seen[name] = jopt.param_label("/".join(path))
        assert topt.param_label(name) == seen[name], name
    assert set(seen.values()) == {"main", "backbone", "frozen"}
    assert seen["backbone.conv0.weight"] == "backbone"
    assert seen["backbone.conv1.weight"] == seen["backbone.layer1_0.conv1.weight"] == "frozen"


@pytest.mark.parametrize("steps", [[0, 1, 9, 10, 19, 20, 35], [0, 1, 49, 50, 99, 100, 250]])
def test_schedules_match_jax(steps):
    for t_sched, j_sched in (
            (topt.step_lr(1e-4, 2, 10), jopt.step_lr(1e-4, 2, 10)),
            (topt.step_lr(3e-4, 1, 5, 0.5), jopt.step_lr(3e-4, 1, 5, 0.5)),
            (topt.cosine_lr(1e-3, 10, 10), jopt.cosine_lr(1e-3, 10, 10)),
            (topt.cosine_lr(1e-3, 20, 5, 0.1, 2.0), jopt.cosine_lr(1e-3, 20, 5, 0.1, 2.0))):
        for s in steps:
            np.testing.assert_allclose(t_sched(s), float(j_sched(jnp.asarray(s))), rtol=1e-6,
                                       atol=1e-9, err_msg=str(s))


CASES = {
    # name: (TrainConfig overrides, make_optimizer kwargs, gradient scale)
    "clip_active": (dict(lr_drop=1), {}, 1.0),
    "clip_inactive": (dict(lr_drop=1), {}, 1e-3),
    "fixed_lr": (dict(lr_drop=1), dict(fixed_lr=1e-5), 1.0),
    "accumulate_2": (dict(lr_drop=1, accumulating_gradient_steps=2), {}, 1.0),
    "cosine": (dict(epochs=4), dict(schedule="cosine"), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_optimizer_matches_optax(case):
    """Three updates on the same gradients.  One epoch per update and
    ``lr_drop`` 1, so the lr drops tenfold at each update: a schedule that
    counted micro-steps would show under accumulation."""
    overrides, kw, scale = CASES[case]
    jt = dataclasses.replace(JTrain(lr=1e-4, lr_backbone=3e-5), **overrides)
    tt = dataclasses.replace(TTrain(lr=1e-4, lr_backbone=3e-5), **overrides)
    every = jt.accumulating_gradient_steps
    rng = np.random.RandomState(len(case))
    params = _tree(rng)
    tx = jopt.make_optimizer(params, jt, steps_per_epoch=1, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    model = _module(from_flax(params, {}))
    opt = topt.make_optimizer(model, tt, steps_per_epoch=1, **kw)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"backbone.conv1.weight", "backbone.layer1_0.conv1.weight"}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    norms = []
    for micro in range(3 * every):
        grads = _jax_frozen_zero(_tree(rng, scale))
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tgrads = from_flax(grads, {})
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[n] if p.grad is None else p.grad + tgrads[n]
        opt.step()
        want = from_flax(jax.tree.map(np.asarray, jparams), {})
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{n} after micro-step {micro}")
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                       for g in jax.tree.leaves(grads)))))
    assert opt.updates == 3 and opt.micro_steps == 3 * every
    for n in frozen:
        assert torch.equal(dict(model.named_parameters())[n], start[n])
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, start[n])]
    assert set(moved) == {n for n in start if n not in frozen}
    clipped = max(norms) > tt.clip_max_norm
    assert clipped == (case != "clip_inactive"), norms


def test_clip_follows_optax_rule():
    """Scale by max / norm (not max / (norm + 1e-6)) when norm >= max."""
    g = [torch.full((4,), 3.0), torch.full((9,), 2.0)]  # norm sqrt(36 + 36)
    norm = topt.clip_by_global_norm_(g, 0.5)
    np.testing.assert_allclose(float(norm), 72 ** 0.5, rtol=1e-6)
    np.testing.assert_allclose(torch.cat(g).numpy(),
                               np.concatenate([np.full(4, 3.0), np.full(9, 2.0)]) * 0.5 / 72 ** 0.5,
                               rtol=1e-6)
    small = [torch.full((2,), 0.1)]
    topt.clip_by_global_norm_(small, 0.5)
    assert torch.equal(small[0], torch.full((2,), 0.1))


def test_every_leaf_decays_without_a_gradient():
    """optax decays every leaf of both groups; a parameter that got no
    gradient still decays (``torch.optim.AdamW`` alone would skip it)."""
    model = _module(from_flax(_tree(np.random.RandomState(0)), {}))
    opt = topt.make_optimizer(
        model, TTrain(lr=1e-2, lr_backbone=1e-2, weight_decay=0.5, adjust_lr=False), 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt.step()  # no backward at all
    for n, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.detach(), before[n] * (1 - 1e-2 * 0.5))
        else:
            assert torch.equal(p, before[n])


def test_ema_update_matches_jax():
    rng = np.random.RandomState(3)
    ema, params = _tree(rng), _tree(rng)
    want = jopt.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, params),
                           0.9996)
    got = [torch.from_numpy(x.copy()) for x in jax.tree.leaves(ema)]
    topt.ema_update(got, [torch.from_numpy(x) for x in jax.tree.leaves(params)], 0.9996)
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
