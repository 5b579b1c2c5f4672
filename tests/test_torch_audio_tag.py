"""The port's audio-tag model, its optimizer and its backbone surgery against
the JAX package's, on the same weights (``weights.from_flax`` of one JAX
init, FrozenBN statistics drawn with numpy) and the same numpy inputs, f32,
at a tiny size (resnet18, 128 x 64 clips, batch 4, 10 classes).

* ``AudioTagBackbone``'s forward for max and avg pooling, with and without
  dilation, logits and sigmoid: atol 1e-5, rtol 1e-4 (f32 convolutions
  summed in another order).
* One update of the trainer's step (logit-space BCE, clip by global norm at
  0.1, Adam) against ``optax.chain(clip_by_global_norm(0.1), adam(lr))``:
  the loss to 1e-5, the global norm before the clip to rtol 1e-4, and every
  updated leaf, stem and ``layer1`` included, to atol 2e-8 (a fifth of a
  percent of the lr 1e-4) and rtol 2.5e-7 (two f32 roundings of the
  parameter) on the entries that the gradients pin.  Adam's first update is
  lr * g / (|g| + eps), about lr * sign(g), so an entry is masked where its
  JAX gradient is below 1e-6 of its leaf's largest (and not exactly 0 on
  both sides, as in the dead units, which do not move), where the two gradients
  differ in sign, or where their first Adam steps differ by more than 1e-4
  of the lr (``tests/test_torch_train_step.py``); the masked entries (under
  a tenth) are held to Adam's bound, lr.
* The staircase lr equals ``optax.exponential_decay(..., staircase=True)``
  at every update count.
* The loss descends from a cold start (no ImageNet weights), as
  ``tests/test_audio_tag.py`` asks of the JAX package.
* ``load_audio_tag_backbone`` copies the leaves that the JAX function
  copies, bit for bit, into a tiny SP-SEDT; a backbone leaf of another shape
  keeps its init, the FrozenBN buffers stay the model's, and nothing of the
  audio-tag head lands.
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
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models.resnet import AudioTagBackbone as JAudioTag
from sound_event_detection_transformer_tpu.utils.checkpoint import (
    load_audio_tag_backbone as jload_audio_tag_backbone,
)
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.models import AudioTagBackbone, build_model
from sound_event_detection_transformer_tpu_torch.parallel.optim import make_audio_tag_optimizer
from sound_event_detection_transformer_tpu_torch.utils.checkpoint import load_audio_tag_backbone
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
B, T, NF, C = 4, 128, 64, 10
LR = 1e-4


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


def _jax_at(**kw):
    return JAudioTag(arch="resnet18", num_classes=C, **kw)


@pytest.fixture(scope="module")
def weights():
    """One JAX init of the tiny audio-tag model (its tree is the same for
    every pooling, dilation and output), FrozenBN statistics drawn, and a
    batch of clips and multi-hot labels."""
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, NF, 1).astype(np.float32)
    y = (rng.rand(B, C) < 0.3).astype(np.float32)
    v = jax.jit(_jax_at().init)(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])), rng)
    return params, frozen, x, y


def _port(params, frozen, **kw) -> AudioTagBackbone:
    model = AudioTagBackbone("resnet18", num_classes=C, **kw).eval()
    model.load_state_dict(from_flax(params, frozen), strict=True)
    return model


def test_from_flax_maps_the_jax_tree_onto_the_module(weights):
    """Every flax leaf has its name in the port and every port entry a flax
    leaf; the dense kernels are transposed."""
    params, frozen, _, _ = weights
    state = from_flax(params, frozen)
    assert set(state) == set(AudioTagBackbone("resnet18", num_classes=C).state_dict())
    assert {k.split(".")[0] for k in state} == {"backbone", "fc1", "fc2"}
    assert state["fc1.weight"].shape == (1000, 512) and state["fc2.weight"].shape == (C, 1000)
    np.testing.assert_array_equal(state["fc2.weight"].numpy(), params["fc2"]["kernel"].T)


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("dilation", [True, False], ids=["dc5", "stride32"])
@pytest.mark.parametrize("logits_out", [True, False], ids=["logits", "sigmoid"])
def test_forward_matches_jax(weights, pooling, dilation, logits_out):
    params, frozen, x, _ = weights
    kw = dict(pooling=pooling, dilation=dilation, logits_out=logits_out)
    want = np.asarray(_jax_at(**kw).apply({"params": params, "frozen": frozen}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, frozen, **kw)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, C)
    if not logits_out:
        assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_pooling_must_be_max_or_avg():
    with pytest.raises(ValueError, match="pooling"):
        AudioTagBackbone("resnet18", pooling="attn")


@pytest.fixture(scope="module")
def one_update(weights):
    """One update on each side from the same weights: JAX's loss, norm,
    gradients and parameters; the port's loss, norm and parameters before
    and after."""
    params, frozen, x, y = weights
    jmodel = _jax_at(pooling="avg", logits_out=True)
    tx = optax.chain(optax.clip_by_global_norm(0.1), optax.adam(LR))

    def loss_fn(p):
        z = jmodel.apply({"params": p, "frozen": frozen}, jnp.asarray(x))
        return optax.sigmoid_binary_cross_entropy(z, jnp.asarray(y)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    want = {"loss": float(loss), "norm": float(optax.global_norm(grads)),
            "grads": from_flax(jax.tree.map(np.asarray, grads), {}),
            "params": from_flax(jax.tree.map(np.asarray, new), {})}

    model = _port(params, frozen, pooling="avg", logits_out=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_audio_tag_optimizer(model, LR, lr_drop=200, steps_per_epoch=1,
                                   clip_max_norm=train_lib.AT_CLIP_MAX_NORM)
    seen = {}
    real_step = opt.step

    def step_keeping_grads():  # the gradients before the clip
        seen["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        real_step()

    opt.step = step_keeping_grads
    step = train_lib.make_audio_tag_step(model, opt)
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in seen["grads"].values()]))
    got = {"loss": loss, "norm": float(norm), "grads": seen["grads"], "before": before,
           "params": {k: v.detach().clone() for k, v in model.named_parameters()},
           "buffers": dict(model.named_buffers()), "updates": opt.updates}
    return want, got


def test_update_loss_and_norm_match_jax(one_update):
    want, got = one_update
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-4)
    assert got["norm"] > train_lib.AT_CLIP_MAX_NORM  # the clip acted
    assert got["updates"] == 1


def test_updated_params_match_jax(one_update):
    """Every parameter is trained, the stem and ``layer1`` too: each leaf
    on the entries its gradients pin (module docstring)."""
    want, got = one_update
    norm = want["norm"]
    eps = 1e-8 / min(1.0, train_lib.AT_CLIP_MAX_NORM / norm)  # Adam's eps before the clip
    n_live = n_all = 0
    assert set(want["params"]) == set(got["params"])
    for name, w in want["params"].items():
        g, g_got = want["grads"][name].numpy(), got["grads"][name].numpy()
        p, w = got["params"][name].numpy(), w.numpy()
        apart = eps * np.abs(g_got - g) / ((np.abs(g) + eps) * (np.abs(g_got) + eps))
        both_zero = (g == 0) & (g_got == 0)  # dead units: no update on either side
        live = (((np.abs(g) >= 1e-6 * np.abs(g).max()) | both_zero)
                & (np.sign(g) == np.sign(g_got)) & (apart <= 1e-4))
        np.testing.assert_allclose(p[live], w[live], rtol=2.5e-7, atol=2e-8, err_msg=name)
        assert (np.abs(p - w) <= 2 * LR + 1e-7).all(), name
        n_live += int(live.sum())
        n_all += live.size
    assert n_live > 0.9 * n_all, (n_live, n_all)


def test_every_leaf_moves_and_buffers_stay(one_update):
    """Nothing is frozen: the stem (``conv0``, ``conv1``) and ``layer1``
    move with the rest; the FrozenBN statistics do not."""
    _, got = one_update
    moved = {n for n, p in got["params"].items() if not torch.equal(p, got["before"][n])}
    assert moved == set(got["params"])
    assert {"backbone.conv0.weight", "backbone.conv1.weight",
            "backbone.layer1_0.conv1.weight"} <= moved
    for name, b in got["buffers"].items():
        assert torch.equal(b, got["before"][name]), name


def test_staircase_lr_matches_optax():
    """``lr * 0.1 ** (update // (lr_drop * steps_per_epoch))``."""
    model = torch.nn.Linear(2, 2)
    opt = make_audio_tag_optimizer(model, 3e-4, lr_drop=2, steps_per_epoch=3, clip_max_norm=0.1)
    sched = optax.exponential_decay(3e-4, 2 * 3, 0.1, staircase=True)
    for count in range(20):
        np.testing.assert_allclose(opt.schedules[0](count), float(sched(count)), rtol=1e-6)


def test_loss_descends_from_a_cold_start():
    """The port's counterpart of ``tests/test_audio_tag.py``: from a cold
    backbone and hot inputs the logit-space BCE moves and descends."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(8, 64, 64, 1) * 3.0).astype(np.float32))
    y = torch.from_numpy((rng.rand(8, 3) < 0.3).astype(np.float32))
    torch.manual_seed(0)
    model = AudioTagBackbone("resnet18", pooling="avg", num_classes=3, logits_out=True).eval()
    step = train_lib.make_audio_tag_step(
        model, make_audio_tag_optimizer(model, 1e-3, lr_drop=200, steps_per_epoch=1,
                                        clip_max_norm=0.1))
    losses = [float(step(x, y)) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    assert len({round(v, 6) for v in losses}) > 1


def test_backbone_surgery_matches_jax(weights):
    """The audio-tag backbone into a tiny SP-SEDT (resnet18, as the
    audio-tag model): JAX's ``load_audio_tag_backbone`` on the flax trees
    and the port's on the module give the same parameters bit for bit; a
    leaf of another shape (``conv0``'s kernel, made 4 channels wide) keeps
    its init on both sides; the buffers stay the SP-SEDT's; ``fc1`` and
    ``fc2`` find no home."""
    at_params, at_frozen, _, _ = weights
    at_params = jax.tree.map(lambda a: a + 0.5, at_params)  # apart from any init
    at_params["backbone"]["conv0"]["kernel"] = np.ones((1, 1, 1, 4), np.float32)
    jcfg = JConfig.tiny_test()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, self_sup=True, dec_at=False,
                                                  num_patches=3, feature_recon=True))
    jmodel, _ = jbuild(jcfg)
    m = jcfg.model
    v = jax.jit(lambda r: jmodel.init(
        {"params": r, "dropout": r, "patch_mask": r}, jnp.zeros((1, m.max_frames, m.n_mels, 1)),
        jnp.zeros((1, m.max_frames), bool), jnp.zeros((1, m.num_patches, 128, 64, 1)), True))(
        jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])),
                            np.random.RandomState(5))
    want = from_flax(jax.tree.map(np.asarray, jload_audio_tag_backbone(params, at_params)), frozen)

    tcfg = TConfig.tiny_test()
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, self_sup=True, dec_at=False,
                                                  num_patches=3, feature_recon=True))
    model, _ = build_model(tcfg, device="cpu")
    model.load_state_dict(from_flax(params, frozen), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    at_state = from_flax(at_params, at_frozen)
    loaded = load_audio_tag_backbone(model, at_state)

    after = model.state_dict()
    assert set(after) == set(want)
    for name, value in after.items():
        assert torch.equal(value, want[name]), name
    buffers = {n for n, _ in model.named_buffers()}
    backbone = {n for n, _ in model.named_parameters() if n.startswith("backbone.")}
    assert set(loaded) == backbone - {"backbone.conv0.weight"}
    for name in buffers | {"backbone.conv0.weight"} | (set(after) - backbone):
        if name not in loaded:
            assert torch.equal(after[name], before[name]), name
    for name in buffers & set(at_state):
        assert not torch.equal(at_state[name], after[name]), name  # the statistics differ
    assert not any(n.startswith(("fc1", "fc2")) for n in after)
