"""SP-SEDT in the port against the JAX package, on the same weights
(``weights.from_flax`` of one JAX init, FrozenBN statistics drawn with
numpy) and the same numpy-seeded clips, f32 at the tiny test geometry
(resnet18, d 64, 1 encoder and 2 decoder layers, 6 queries from 3 patches
of 128 x 64 cropped out of 128 x 32 clips, so the crop resizes along F too):

* the ``SPSEDT`` forward, deterministic (also with fewer patches than
  ``num_patches``) and training at ``mask_ratio`` 0.0 (every patch query
  kept) and 1.0 (none kept: the queries are twice the learned ones), with and
  without ``feature_recon``.  The keep mask and the query shuffle come from
  each package's own random stream, which the other cannot repeat, so these
  two ratios are where the draws decide nothing; 0.1 is held statistically,
  and the shuffle by replaying the permutation from a clone of the generator;
* ``loss_feature`` and the whole criterion on the same outputs;
* one train step against one JAX ``make_train_step`` call (``mask_ratio`` 0,
  dropout 0, ``lr_backbone`` 0, the patch crops on the device in both): the
  losses, every gradient (the backbone's too, which the patch pass reaches
  through the unstopped reconstruction target), the updated leaves, and the
  lr-0 backbone leaves bit for bit unchanged on both sides;
* ``load_pretrain_into`` against the JAX package's on the same two trees.

Tolerances: outputs and losses atol 1e-4, rtol 1e-4 (f32 sums in another
order, as in ``test_torch_model``); gradients and updated parameters as in
``test_torch_train_step`` (JAX's CPU f32 gradients are the noisy side);
the surgery exactly.
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
from sound_event_detection_transformer_tpu.models import criterion as jcriterion
from sound_event_detection_transformer_tpu.ops.matcher import MatchResult as JMatch
from sound_event_detection_transformer_tpu.ops.patches import (
    extract_patches_device as jextract,
)
from sound_event_detection_transformer_tpu.parallel.optim import make_optimizer as jmake_optimizer
from sound_event_detection_transformer_tpu.utils.checkpoint import (
    load_pretrain_into as jload_pretrain_into,
)
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
from sound_event_detection_transformer_tpu_torch.models import criterion as tcriterion
from sound_event_detection_transformer_tpu_torch.ops.matcher import MatchResult as TMatch
from sound_event_detection_transformer_tpu_torch.ops.patches import extract_patches_device
from sound_event_detection_transformer_tpu_torch.parallel.optim import param_label
from sound_event_detection_transformer_tpu_torch.utils.checkpoint import load_pretrain_into
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_train_step import _grad_atol, _keep_grads, _random_frozen

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B, P, Q, SEED = 4, 3, 6, 7
STEPS_PER_EPOCH = 10


def _configs(cfg_cls, feature_recon=True, mask_ratio=0.0, query_shuffle=False, **model_kw):
    """The tiny config as SP-SEDT: 6 queries from 3 patches, no dropout,
    lr_backbone 0 (the pretrainer's), the given keep ratio."""
    cfg = cfg_cls.tiny_test()
    model = dataclasses.replace(cfg.model, self_sup=True, dec_at=False, num_queries=Q,
                                num_patches=P, feature_recon=feature_recon,
                                mask_ratio=mask_ratio, query_shuffle=query_shuffle, dropout=0.0,
                                **model_kw)
    return cfg.replace(model=model, train=dataclasses.replace(cfg.train, lr_backbone=0.0))


def _np(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _datasets(jcfg, tcfg):
    """The same unlabeled clips with patch boxes on both sides: JAX draws the
    boxes from numpy's global stream, the port from its own RandomState."""
    m = jcfg.model
    np.random.seed(SEED)
    jenc = JEncoder(1, 10.0, generate_patch=True)
    jds = JSynthetic(B, list(jcfg.data.classes), m.max_frames, m.n_mels, jenc.encode_strong_df,
                     max_events=2, seed=SEED, unlabel=True, num_patches=P, device_patches=True)
    jbatch = jdataset.collate([jds[i] for i in range(B)], m.max_events, 10.0)
    tenc = TEncoder(1, 10.0, generate_patch=True)
    tds = TSynthetic(B, list(tcfg.data.classes), m.max_frames, m.n_mels, tenc.encode_strong_df,
                     max_events=2, seed=SEED, unlabel=True, num_patches=P,
                     rng=np.random.RandomState(SEED))
    tbatch = tdataset.collate([tds[i] for i in range(B)], m.max_events, 10.0)
    return jbatch, tbatch


@pytest.fixture(scope="module")
def weights_and_batches():
    """One JAX init of the feature_recon model (whose tree holds the other's),
    FrozenBN statistics away from the identity, and both packages' batch."""
    jcfg = _configs(JConfig)
    jbatch, tbatch = _datasets(jcfg, _configs(TConfig))
    patches = jextract(jnp.asarray(jbatch.feats), jnp.asarray(jbatch.targets.boxes[:, :P]))
    jmodel, _ = jbuild(jcfg)
    v = jax.jit(lambda r: jmodel.init({"params": r, "patch_mask": r}, jnp.asarray(jbatch.feats),
                                      jnp.asarray(jbatch.pad_mask), patches, True))(
        jax.random.PRNGKey(SEED))
    params = _np(v["params"])
    frozen = _random_frozen(_np(v["frozen"]), np.random.RandomState(SEED))
    return params, frozen, jbatch, tbatch


def _without_feature_align(params):
    return {k: v for k, v in params.items() if k != "feature_align"}


def _port_model(params, frozen, **kw):
    tcfg = _configs(TConfig, **kw)
    model, wd = tbuild(tcfg, device="cpu")
    if not tcfg.model.feature_recon:
        params = _without_feature_align(params)
    model.load_state_dict(from_flax(params, frozen), strict=True)
    return tcfg, model, wd


def test_batches_and_patch_boxes_match(weights_and_batches):
    """The port's dataset draws the JAX package's boxes, draw for draw, and
    its device crops equal JAX's."""
    _, _, jbatch, tbatch = weights_and_batches
    for name, w, g in zip(jbatch.targets._fields, jbatch.targets, tbatch.targets):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(tbatch.strong.numpy(), np.asarray(jbatch.strong))
    assert tbatch.strong.all() and tbatch.targets.box_valid[:, :P].all()
    np.testing.assert_array_equal(tbatch.feats.numpy(), np.asarray(jbatch.feats))
    got = extract_patches_device(tbatch.feats, tbatch.targets.boxes[:, :P])
    want = jextract(jnp.asarray(jbatch.feats), jnp.asarray(jbatch.targets.boxes[:, :P]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


FORWARDS = {  # name: (deterministic, mask_ratio, patches used)
    "deterministic": (True, 0.0, P),
    "deterministic_two_patches": (True, 0.0, 2),
    "train_mask_0": (False, 0.0, P),
    "train_mask_1": (False, 1.0, P),
}


@pytest.mark.parametrize("feature_recon", [True, False], ids=["feature_recon", "plain"])
@pytest.mark.parametrize("mode", list(FORWARDS))
def test_forward_matches_jax(weights_and_batches, mode, feature_recon):
    params, frozen, jbatch, tbatch = weights_and_batches
    deterministic, ratio, p = FORWARDS[mode]
    jcfg = _configs(JConfig, feature_recon=feature_recon, mask_ratio=ratio)
    jmodel, _ = jbuild(jcfg)
    jparams = params if feature_recon else _without_feature_align(params)
    jpatches = jextract(jnp.asarray(jbatch.feats), jnp.asarray(jbatch.targets.boxes[:, :p]))
    key = jax.random.PRNGKey(1)
    want = jmodel.apply({"params": jparams, "frozen": frozen}, jnp.asarray(jbatch.feats),
                        jnp.asarray(jbatch.pad_mask), jpatches, deterministic,
                        rngs={"patch_mask": key, "dropout": key})

    _, model, _ = _port_model(params, frozen, feature_recon=feature_recon, mask_ratio=ratio)
    tpatches = extract_patches_device(tbatch.feats, tbatch.targets.boxes[:, :p])
    with torch.no_grad():
        got = model(tbatch.feats, tbatch.pad_mask, tpatches, deterministic=deterministic,
                    generator=torch.Generator().manual_seed(1))
    assert set(got) == set(want)
    assert got["pred_logits"].shape == (B, p * Q // P if deterministic else Q, 2)
    if feature_recon:
        assert got["gt_feature"].shape == (B, p, 512)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k, **TOL)


def _record_queries(model):
    """Make ``model.encode`` keep its query override and stop the forward."""
    seen = []

    class Stop(Exception):
        pass

    def encode(*a, query_override=None, **kw):
        seen.append(query_override)
        raise Stop

    model.encode = encode
    return seen, Stop


def test_keep_mask_at_ratio_0_1_statistically(weights_and_batches):
    """At the recipe's ratio 0.1 each (clip, query) keeps its patch query
    with probability 0.9, one draw for all its channels: over 12,000 draws
    the masked share is 0.1 within 0.01 (3.6 standard deviations)."""
    params, frozen, _, _ = weights_and_batches
    _, model, _ = _port_model(params, frozen, mask_ratio=0.1)
    seen, stop = _record_queries(model)
    gen = torch.Generator().manual_seed(0)
    b = 200
    patches = torch.randn(b, P, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    feats, pad = torch.zeros(b, 16, 16, 1), torch.zeros(b, 16, dtype=torch.bool)
    masked = []
    with torch.no_grad():
        for _ in range(10):
            with pytest.raises(stop):
                model(feats, pad, patches, deterministic=False, generator=gen)
            pq = seen[-1] - 2.0 * model.query_embed.weight[None]  # pq * keep
            off = (pq == 0).all(-1)
            assert ((pq == 0).any(-1) == off).all()  # one draw a query
            masked.append(off)
    share = torch.stack(masked).float().mean().item()
    assert abs(share - 0.1) < 0.01, share
    assert not torch.equal(masked[0], masked[1])


@pytest.mark.parametrize("ratio", [0.0, 1.0])
def test_query_shuffle_replays_from_a_clone_of_the_generator(weights_and_batches, ratio):
    """With ``query_shuffle`` the event queries are permuted by one
    ``randperm`` drawn before the keep mask, both from the step's generator."""
    params, frozen, _, tbatch = weights_and_batches
    _, model, _ = _port_model(params, frozen, mask_ratio=ratio, query_shuffle=True)
    seen, stop = _record_queries(model)
    gen = torch.Generator().manual_seed(5)
    clone = torch.Generator().manual_seed(5)
    patches = extract_patches_device(tbatch.feats, tbatch.targets.boxes[:, :P])
    with torch.no_grad():
        with pytest.raises(stop):
            model(tbatch.feats, tbatch.pad_mask, patches, deterministic=False, generator=gen)
        perm = torch.randperm(Q, generator=clone)
        keep = torch.rand((B, Q, 1), generator=clone) > ratio
        pq = model.patch2query(model.backbone(patches.flatten(0, 1)).mean(dim=(1, 2)))
        pq = pq.reshape(B, P, 1, -1).expand(-1, -1, Q // P, -1).reshape(B, Q, -1)
        want = 2.0 * model.query_embed.weight[perm][None] + pq * keep
    assert not torch.equal(perm, torch.arange(Q))
    torch.testing.assert_close(seen[0], want, rtol=0, atol=0)


def test_loss_feature_matches_jax():
    """On seeded features and a seeded assignment (some queries unmatched,
    one clip not strong), with a zero target vector under the 1e-12 guard."""
    rng = np.random.RandomState(3)
    pred = rng.randn(B, Q, 16).astype(np.float32)
    gt = rng.randn(B, P, 16).astype(np.float32)
    gt[1, 2] = 0.0
    tgt = rng.randint(-1, P, size=(B, Q)).astype(np.int32)
    matched = tgt >= 0
    strong = np.array([1, 1, 0, 1], np.float32)
    fields = dict(tgt_for_query=tgt, query_matched=matched,
                  query_for_tgt=np.zeros((B, P), np.int32), tgt_matched=np.ones((B, P), bool),
                  coef=np.ones((B, Q), np.float32), num_boxes=matched.sum(1).astype(np.float32))
    num_boxes = np.float32(7.0)
    want = jcriterion.loss_feature(jnp.asarray(pred), jnp.asarray(gt),
                                   JMatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                   jnp.asarray(strong), jnp.asarray(num_boxes))
    got = tcriterion.loss_feature(torch.from_numpy(pred), torch.from_numpy(gt),
                                  TMatch(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                                  torch.from_numpy(strong), torch.tensor(num_boxes))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_criterion_matches_jax(weights_and_batches):
    """The whole criterion (joint matching of the final and aux layer, the
    class, box and feature losses of both) on JAX's deterministic outputs."""
    params, frozen, jbatch, tbatch = weights_and_batches
    jcfg = _configs(JConfig)
    jmodel, jwd = jbuild(jcfg)
    jpatches = jextract(jnp.asarray(jbatch.feats), jnp.asarray(jbatch.targets.boxes[:, :P]))
    out = jmodel.apply({"params": params, "frozen": frozen}, jnp.asarray(jbatch.feats),
                       jnp.asarray(jbatch.pad_mask), jpatches, True)
    targets = jax.tree.map(jnp.asarray, jbatch.targets)
    want, _ = jax.jit(lambda o, t, s: jcriterion.set_criterion(o, t, s, None, jcfg.model,
                                                               jcfg.loss))(
        out, targets, jnp.asarray(jbatch.strong))
    tcfg = _configs(TConfig)
    _, twd = tbuild(tcfg, device="cpu")
    got, _ = tcriterion.set_criterion({k: torch.from_numpy(np.array(v)) for k, v in out.items()},
                                      tbatch.targets, tbatch.strong, None, tcfg.model, tcfg.loss)
    assert twd == jwd and {"loss_feature", "loss_feature_0"} <= set(twd)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k, **TOL)
    np.testing.assert_allclose(tcriterion.total_loss(got, twd).item(),
                               float(jcriterion.total_loss(want, jwd)), **TOL)


@pytest.fixture(scope="module")
def steps(weights_and_batches):
    """One SP-SEDT train step of each package from the same state."""
    params, frozen, jbatch, tbatch = weights_and_batches
    jcfg = _configs(JConfig)
    jmodel, jwd = jbuild(jcfg)
    tx = optax.chain(_keep_grads(), jmake_optimizer(params, jcfg.train, STEPS_PER_EPOCH))
    jparams = jax.tree.map(jnp.asarray, params)
    state = JTrainState(jparams, jax.tree.map(jnp.asarray, frozen), tx.init(jparams),
                        jnp.asarray(0))
    jstep = jmake_train_step(jmodel, jwd, jcfg, tx, augment_on=False)
    new_state, jmetrics = jstep(
        state, jax.tree.map(lambda x: None if x is None else jnp.asarray(x), jbatch),
        jax.random.PRNGKey(0))
    want = {"metrics": {k: np.asarray(v) for k, v in jmetrics.items()},
            "grads": from_flax(_np(new_state.opt_state[0]), {}),
            "params": from_flax(_np(new_state.params), frozen)}

    tcfg, model, twd = _port_model(params, frozen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstate = init_train_state(model, tcfg, STEPS_PER_EPOCH)
    loss, _ = make_loss_fn(model, twd, tcfg)(tbatch.feats, tbatch.pad_mask, tbatch.targets,
                                             tbatch.strong, tbatch.weak,
                                             torch.Generator().manual_seed(0),
                                             tbatch.targets.boxes[:, :P])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    tstate.optimizer.adamw.zero_grad(set_to_none=False)
    step = make_train_step(model, twd, tcfg, tstate.optimizer, augment_on=False, device="cpu")
    metrics = step(tbatch, torch.Generator().manual_seed(0))
    got = {"metrics": metrics, "grads": grads, "params": model.state_dict(), "before": before}
    return want, got, tcfg


def test_step_losses_match_jax(steps):
    want, got, _ = steps
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"loss_feature", "loss_feature_0"} <= set(got["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), w, err_msg=k, **TOL)


def test_step_gradients_match_jax_with_the_patch_pass(steps):
    """Every trainable leaf's gradient, the lr-0 backbone's included: the
    reconstruction target is not detached, so the patch pass adds to them."""
    want, got, _ = steps
    atol = _grad_atol(want["grads"])
    for name, w in want["grads"].items():
        if param_label(name) == "frozen":
            assert name not in got["grads"] and not w.any(), name
            continue
        np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=atol[name], err_msg=name)
    backbone = [n for n in got["grads"] if param_label(n) == "backbone"]
    assert backbone and all(got["grads"][n].abs().max() > 0 for n in backbone)
    assert {"patch2query.weight", "feature_align.layer1.weight"} <= set(got["grads"])


def test_step_keeps_lr0_backbone_leaves_and_updates_the_rest(steps):
    """The backbone group at lr 0 (and the frozen leaves and buffers) come
    out bit for bit unchanged on both sides; the others match JAX's update
    on the entries their gradients pin (``test_torch_train_step``'s rule)."""
    want, got, tcfg = steps
    lr, wd = tcfg.train.lr, tcfg.train.weight_decay
    for name, before in got["before"].items():
        if param_label(name) != "main" or name not in want["grads"]:  # backbone, frozen, buffers
            assert torch.equal(got["params"][name], before), name
            assert torch.equal(want["params"][name], before), name
    main = [n for n in want["grads"] if param_label(n) == "main"]
    trainable = [n for n in want["grads"] if param_label(n) != "frozen"]
    norm = float(np.sqrt(sum((want["grads"][n].numpy().astype(np.float64) ** 2).sum()
                             for n in trainable)))
    eps = 1e-8 / min(1.0, tcfg.train.clip_max_norm / norm)
    n_live = n_all = n_moved = 0
    for name in main:
        g, g_got = want["grads"][name].numpy(), got["grads"][name].numpy()
        w, p = want["params"][name].numpy(), got["params"][name].numpy()
        apart = eps * np.abs(g_got - g) / ((np.abs(g) + eps) * (np.abs(g_got) + eps))
        both_zero = (g == 0) & (g_got == 0)
        live = (((np.abs(g) >= 1e-6 * np.abs(g).max()) | both_zero)
                & (np.sign(g) == np.sign(g_got)) & (apart <= 1e-4))
        np.testing.assert_allclose(p[live], w[live], rtol=2.5e-7, atol=2e-8, err_msg=name)
        bound = 2 * lr * (1 + wd * np.abs(got["before"][name].numpy())) + 1e-7
        assert (np.abs(p - w) <= bound).all(), name
        n_moved += not np.array_equal(p, got["before"][name].numpy())
        n_live += int(live.sum())
        n_all += live.size
    assert n_live > 0.9 * n_all, (n_live, n_all)
    assert n_moved > 0.9 * len(main), (n_moved, len(main))


def _seeded_tree(model, rng, *args):
    """(params, frozen) of ``model.init`` with seeded values: the tree is
    traced, not computed (the surgery reads names and shapes only)."""
    keys = {"params": jax.random.PRNGKey(0), "patch_mask": jax.random.PRNGKey(0)}
    shapes = jax.eval_shape(lambda: model.init(keys, *args, True))
    fill = lambda x: rng.randn(*x.shape).astype(np.float32)
    return (_np(jax.tree.map(fill, shapes["params"])),
            _np(jax.tree.map(fill, shapes["frozen"])))


def test_load_pretrain_into_matches_jax():
    """JAX's surgery and the port's, from a 2-encoder-layer SP-SEDT tree
    into a 1-layer SEDT fine-tune tree with ``dec_at`` (seeded values): the
    same parameters come out; the FrozenBN buffers stay the fine-tune's own."""
    ft_cfg = JConfig.tiny_test()
    m = ft_cfg.model
    feats, pad = jnp.zeros((1, m.max_frames, m.n_mels, 1)), jnp.zeros((1, m.max_frames), bool)
    pre_params, pre_frozen = _seeded_tree(jbuild(_configs(JConfig, enc_layers=2))[0],
                                          np.random.RandomState(1), feats, pad,
                                          jnp.zeros((1, P, 128, 64, 1)))
    ft_params, ft_frozen = _seeded_tree(jbuild(ft_cfg)[0], np.random.RandomState(2), feats, pad)
    merged = from_flax(_np(jload_pretrain_into(ft_params, pre_params)), ft_frozen)

    model, _ = tbuild(TConfig.tiny_test(), device="cpu")
    model.load_state_dict(from_flax(ft_params, ft_frozen), strict=True)
    pre_state = from_flax(pre_params, pre_frozen)
    loaded = load_pretrain_into(model, pre_state)
    got = model.state_dict()
    assert set(got) == set(merged)
    for k, w in merged.items():
        assert torch.equal(got[k], w), k
    ft_state = from_flax(ft_params, ft_frozen)
    buffers = {n for n, _ in model.named_buffers()}
    assert buffers and all(torch.equal(got[n], ft_state[n]) for n in buffers)
    assert not any("class_embed" in n or "encoder_layer_1" in n for n in loaded)
    assert "query_embed.weight" in loaded and "backbone.conv0.weight" in loaded
    assert torch.equal(got["query_embed.weight"][0], ft_state["query_embed.weight"][0])
    assert torch.equal(got["query_embed.weight"][1:], pre_state["query_embed.weight"])


def test_patch_items_draw_jax_boxes_through_getitem_and_targets_only():
    """On the patch path an item carries its fresh boxes and no crops (the
    step crops on the device), and ``__getitem__`` and ``targets_only`` (the
    feature bank's route) draw from one stream in call order: interleaved,
    they give the JAX package's ``device_patches`` items draw for draw."""
    m = _configs(JConfig).model
    np.random.seed(SEED)
    jds = JSynthetic(B, ["a"], m.max_frames, m.n_mels,
                     JEncoder(1, 10.0, generate_patch=True).encode_strong_df, max_events=2,
                     seed=SEED, unlabel=True, num_patches=P, device_patches=True)
    tds = TSynthetic(B, ["a"], m.max_frames, m.n_mels,
                     TEncoder(1, 10.0, generate_patch=True).encode_strong_df, max_events=2,
                     seed=SEED, unlabel=True, num_patches=P, rng=np.random.RandomState(SEED))
    for i in range(B):
        for j, t in ((jds[i][1], tds[i][1]), (jds.targets_only(i, 40), tds.targets_only(i, 40))):
            assert set(t) == set(j) and "patches" not in t and t["boxes"].shape == (P, 2)
            for k in j:
                np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)
