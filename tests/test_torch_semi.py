"""The mean-teacher step of the PyTorch port against the JAX package's, on the
CPU, piece by piece and whole.

* ``same_class_nms``: the keep masks equal exactly, on random clips and on
  hypothesis cases with tied scores, boxes that only touch (overlap 0: the
  boxes sit on a 1/16 grid, so both packages compute the touch exactly),
  invalid rows and clips of one class.
* ``get_pseudo_labels``: from the same numpy teacher outputs, with and
  without ``at``, fewer and more queries than slots: labels, validity and
  counts exactly, boxes to 1e-6.
* ``adjust_threshold``: exactly, a zero total included.
* ``set_criterion(precomputed=joint_match(...))`` equals the criterion's own
  solve; the box loss's L1 takes ``jnp.abs``'s subgradient at 0.
* One ``make_semi_train_step`` against one of JAX's on
  ``SEDTConfig.tiny_test()`` at dropout 0 and no mixup (the two packages'
  random streams differ), from the same ``from_flax`` weights: the student
  from one JAX init (FrozenBN statistics drawn with numpy), the teacher from
  the same parameters moved by 1 % noise, and the same clean (teacher) and
  noisy (student) features of 2 strong, 2 weak and 4 unlabeled clips.  The
  thresholds [0.12, 0.2, 0.25, 0.5] let the teacher label every unlabeled
  clip (the fixture checks that every teacher score lies more than 1e-4
  from its class's threshold, so that the two forwards, 1e-6 apart, keep
  the same events).  Plain matching with ``n_labeled`` 4 and without (the
  full-batch fallback), ``fine_tune`` (alpha 100, so its relaxed stage keeps
  every candidate and draws decide nothing) and ``normalize``.  Checked:
  the loss and every ``sup_*`` / ``unsup_*`` term to ``TOL``, the counts
  exactly and above 0, the updated student on the entries that the two
  gradients pin (``test_torch_train_step``'s tolerances and mask), the
  teacher after ``do_ema``: |port - JAX| <= (1 - d) |student_port -
  student_JAX| + two f32 roundings, every parameter (the frozen ones too),
  and without ``do_ema`` the teacher unchanged bit for bit.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sound_event_detection_transformer_tpu import engine as jengine
from sound_event_detection_transformer_tpu.config import DCASE_CLASS_PRIOR as JAX_PRIOR
from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models.criterion import DenseTargets as JTargets
from sound_event_detection_transformer_tpu.models.postprocess import postprocess as jpostprocess
from sound_event_detection_transformer_tpu.ops import box_ops as jbox_ops
from sound_event_detection_transformer_tpu.parallel.optim import make_optimizer as jmake_optimizer
from sound_event_detection_transformer_tpu_torch import engine
from sound_event_detection_transformer_tpu_torch.config import DCASE_CLASS_PRIOR
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.data.dataset import collate
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset
from sound_event_detection_transformer_tpu_torch.models import build_model, set_criterion
from sound_event_detection_transformer_tpu_torch.models.criterion import DenseTargets, joint_match
from sound_event_detection_transformer_tpu_torch.ops import box_ops
from sound_event_detection_transformer_tpu_torch.parallel.optim import param_label
from sound_event_detection_transformer_tpu_torch.weights import from_flax
from test_torch_train_step import _configs, _keep_grads, _random_frozen

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
SIZES = (2, 2, 4)  # strong, weak, unlabeled rows
N_LAB = SIZES[0] + SIZES[1]
THRESHOLDS = np.array([0.12, 0.2, 0.25, 0.5], np.float32)
STEPS_PER_EPOCH = 10


# ------------------------------------------------------------ same_class_nms

_jnms = jax.jit(jax.vmap(jengine.same_class_nms))


def _nms_both(scores, labels, boxes, valid):
    want = np.asarray(_jnms(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(boxes),
                            jnp.asarray(valid)))
    got = engine.same_class_nms(torch.from_numpy(scores), torch.from_numpy(labels),
                                torch.from_numpy(boxes), torch.from_numpy(valid)).numpy()
    return want, got


@pytest.mark.parametrize("seed", range(4))
def test_same_class_nms_matches_jax_on_random_clips(seed):
    rng = np.random.RandomState(seed)
    b, q = 6, 20
    scores = rng.rand(b, q).astype(np.float32)
    labels = rng.randint(0, 3, (b, q)).astype(np.int32)
    boxes = np.stack([rng.rand(b, q), rng.rand(b, q) * 0.3], -1).astype(np.float32)
    valid = rng.rand(b, q) < 0.8
    want, got = _nms_both(scores, labels, boxes, valid)
    np.testing.assert_array_equal(got, want)
    assert want.any() and (valid & ~want).any()  # some kept, some suppressed


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_same_class_nms_matches_jax_on_ties_touches_and_one_class(data):
    q = 8
    grid = st.integers(0, 16)
    scores = np.array(data.draw(st.lists(st.sampled_from([0.25, 0.5, 0.75]), min_size=q,
                                         max_size=q)), np.float32)[None]
    n_classes = data.draw(st.sampled_from([1, 2]))
    labels = np.array(data.draw(st.lists(st.integers(0, n_classes - 1), min_size=q,
                                         max_size=q)), np.int32)[None]
    centers = np.array(data.draw(st.lists(grid, min_size=q, max_size=q)), np.float32) / 16
    lengths = np.array(data.draw(st.lists(st.integers(0, 4), min_size=q, max_size=q)),
                       np.float32) * 2 / 16
    boxes = np.stack([centers, lengths], -1)[None]
    valid = np.array(data.draw(st.lists(st.booleans(), min_size=q, max_size=q)))[None]
    want, got = _nms_both(scores, labels, boxes, valid)
    np.testing.assert_array_equal(got, want)
    assert not (got & ~valid).any()


def test_same_class_nms_keeps_touching_boxes_and_breaks_ties_by_index():
    """Two boxes that only touch both stay; of two equal scores that overlap
    the lower index wins, as ``jnp.argsort``'s stable order has it."""
    scores = np.array([[0.5, 0.5, 0.5, 0.9]], np.float32)
    labels = np.zeros((1, 4), np.int32)
    boxes = np.array([[[0.25, 0.25], [0.5, 0.25], [0.3125, 0.125], [0.875, 0.125]]],
                     np.float32)  # [0.125, 0.375] touches [0.375, 0.625]; 2 overlaps 0
    valid = np.ones((1, 4), bool)
    want, got = _nms_both(scores, labels, boxes, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[True, True, False, True]])


# --------------------------------------------------------- get_pseudo_labels


def _teacher_outputs(rng, b, q, c, with_at):
    out = {"pred_logits": (rng.randn(b, q, c + 1) * 2).astype(np.float32),
           "pred_boxes": np.stack([rng.rand(b, q), rng.rand(b, q) * 0.5], -1).astype(np.float32)}
    if with_at:
        out["at"] = rng.rand(b, c).astype(np.float32)
    return out


@pytest.mark.parametrize("q,m", [(6, 8), (12, 5)], ids=["slots_left", "queries_cut"])
@pytest.mark.parametrize("with_at", [True, False], ids=["at", "no_at"])
def test_get_pseudo_labels_matches_jax(q, m, with_at):
    rng = np.random.RandomState(q + m + with_at)
    b, c = 8, 4
    out = _teacher_outputs(rng, b, q, c, with_at)
    thr = np.array([0.2, 0.3, 0.25, 0.6], np.float32)
    sizes = np.full((b,), 10.0, np.float32)
    want, want_counts = jengine.get_pseudo_labels({k: jnp.asarray(v) for k, v in out.items()},
                                                  jnp.asarray(thr), jnp.asarray(sizes), m)
    got, got_counts = engine.get_pseudo_labels({k: torch.from_numpy(v) for k, v in out.items()},
                                               torch.from_numpy(thr), torch.from_numpy(sizes), m)
    for name in ("labels", "box_valid", "label_valid", "ratio", "orig_size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert got.labels.dtype == torch.int32 and got.box_valid.shape == (b, m)
    assert 0 < got_counts.sum() < b * min(q, m)  # some events kept, some filtered


# ---------------------------------------------------------- adjust_threshold


@pytest.mark.parametrize("counts", [[3, 0, 7, 1, 0, 0, 2, 9, 40, 1], [0] * 10, [5] + [0] * 9],
                         ids=["spread", "zero", "one_class"])
def test_adjust_threshold_matches_jax(counts):
    counts = np.asarray(counts, np.float64)
    prior = np.asarray(DCASE_CLASS_PRIOR, np.float64)
    prior = prior / prior.sum()
    origin = np.full((10,), 0.5)
    want = jengine.adjust_threshold(counts, origin, prior)
    got = engine.adjust_threshold(counts, origin, prior)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64
    if not counts.any():
        assert got is origin


def test_port_prior_is_the_jax_packages():
    assert DCASE_CLASS_PRIOR == JAX_PRIOR


# ------------------------------------------------------- precomputed matching


def test_precomputed_matching_equals_the_criterions_own_solve():
    cfg = TConfig.tiny_test()
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    m = cfg.model
    enc = BoxEncoder(list(cfg.data.classes), cfg.features.max_len_seconds)
    ds = SyntheticDataset(4, cfg.data.classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                          max_events=4, seconds=cfg.features.max_len_seconds, seed=3)
    batch = collate([ds[i] for i in range(4)], m.max_events, cfg.features.max_len_seconds)
    with torch.no_grad():
        out = model(batch.feats, batch.pad_mask)
    own, own_m = set_criterion(out, batch.targets, batch.strong, batch.weak, m, cfg.loss)
    pre = joint_match(out, batch.targets, cfg.loss)
    shared, shared_m = set_criterion(out, batch.targets, batch.strong, batch.weak, m, cfg.loss,
                                     precomputed=pre)
    assert set(own) == set(shared) and "loss_ce_0" in own
    for k, v in own.items():
        assert torch.equal(shared[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(own_m, shared_m))
    with pytest.raises(ValueError, match="plain matching"):
        set_criterion(out, batch.targets, batch.strong, batch.weak, m, cfg.loss,
                      fine_tune=True, precomputed=pre)


def test_l1_subgradient_at_a_zero_difference_is_jaxs():
    """A prediction equal to its target (the semi step's first pseudo boxes,
    whose teacher is the student) gets ``jnp.abs``'s subgradient, +1, in
    the box loss's L1; away from 0 the sign of the difference."""
    target = np.array([[0.3, 0.2], [0.6, 0.1], [0.5, 0.25]], np.float32)
    pred = target.copy()
    pred[2] += 0.125
    jgrad = jax.grad(lambda p: jbox_ops.elementwise_l1_se(
        jbox_ops.box_cl_to_se(p), jbox_ops.box_cl_to_se(jnp.asarray(target))).sum())(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    box_ops.elementwise_l1_se(box_ops.box_cl_to_se(p),
                              box_ops.box_cl_to_se(torch.from_numpy(target))).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(p.grad.numpy()[0], [2.0, 0.0])


# ------------------------------------------------------------ the whole step

KINDS = {"plain": ({}, N_LAB), "full_batch": ({}, None),
         "fine_tune": ({"fine_tune": True}, N_LAB), "normalize": ({"normalize": True}, N_LAB)}


def _semi_batch(tcfg):
    """2 strong, 2 weak and 4 unlabeled seeded clips (dense targets, numpy),
    their features and a noisy copy (the student's view)."""
    m = tcfg.model
    sec = tcfg.features.max_len_seconds
    enc = BoxEncoder(list(tcfg.data.classes), sec)
    mk = lambda n, seed, **kw: SyntheticDataset(n, tcfg.data.classes, m.max_frames, m.n_mels,
                                                enc.encode_strong_df, max_events=4, seconds=sec,
                                                seed=seed, **kw)
    items = ([mk(SIZES[0], 5)[i] for i in range(SIZES[0])]
             + [mk(SIZES[1], 6, weak_only=True)[i] for i in range(SIZES[1])]
             + [mk(SIZES[2], 7, unlabel=True)[i] for i in range(SIZES[2])])
    batch = collate(items, m.max_events, sec)
    feats = batch.feats.numpy()
    noisy = feats + np.random.RandomState(8).randn(*feats.shape).astype(np.float32) * 0.1
    pos = np.arange(sum(SIZES))
    flags = (pos < SIZES[0], (pos >= SIZES[0]) & (pos < N_LAB), pos >= N_LAB)
    return feats, noisy, batch.pad_mask.numpy(), [t.numpy() for t in batch.targets], flags


@pytest.fixture(scope="module")
def weights_and_batch():
    """The student's and the teacher's parameters, the FrozenBN statistics
    and the batch; asserts the thresholds' margin from the teacher's scores."""
    jcfg = _configs(JConfig)
    feats, noisy, pad, targets, flags = _semi_batch(_configs(TConfig))
    jmodel, _ = jbuild(jcfg)
    v = jax.jit(lambda r: jmodel.init({"params": r}, jnp.asarray(feats), jnp.asarray(pad),
                                      True))(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, flax.core.unfreeze(v["params"]))
    frozen = _random_frozen(jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"])),
                            np.random.RandomState(3))
    rng = np.random.RandomState(4)
    teacher = jax.tree.map(lambda x: (x + 0.01 * rng.randn(*x.shape) * np.abs(x).mean())
                           .astype(np.float32), params)
    out = jmodel.apply({"params": teacher, "frozen": frozen}, jnp.asarray(feats[N_LAB:]),
                       jnp.asarray(pad[N_LAB:]), True)
    tags = (out["at"] >= jnp.asarray(THRESHOLDS)[None]).astype(jnp.float32)
    pp = jpostprocess(out, jnp.asarray(targets[5][N_LAB:]), audio_tags=tags, at_m=1,
                      is_semi=True, threshold=None)
    margin = np.abs(np.asarray(pp.scores) - THRESHOLDS[np.asarray(pp.labels)])
    assert margin.min() > 1e-4, margin.min()
    at_margin = np.abs(np.asarray(out["at"]) - THRESHOLDS[None])
    assert at_margin.min() > 1e-4, at_margin.min()
    return params, teacher, frozen, (feats, noisy, pad, targets, flags)


def _jax_step(kind, n_labeled, params, teacher, frozen, batch, do_ema):
    jcfg = _configs(JConfig)
    jmodel, jwd = jbuild(jcfg)
    tx = optax.chain(_keep_grads(), jmake_optimizer(params, jcfg.train, STEPS_PER_EPOCH,
                                                    schedule="cosine"))
    jparams = jax.tree.map(jnp.asarray, params)
    state = jengine.TrainState(jparams, jax.tree.map(jnp.asarray, frozen), tx.init(jparams),
                               jnp.asarray(0))
    step = jengine.make_semi_train_step(jmodel, jwd, jcfg, tx, n_labeled=n_labeled, **kind)
    feats, noisy, pad, targets, flags = batch
    new_state, new_ema, metrics, counts = step(
        state, jax.tree.map(jnp.asarray, teacher), jnp.asarray(feats), jnp.asarray(noisy),
        jnp.asarray(pad), JTargets(*(jnp.asarray(t) for t in targets)),
        *(jnp.asarray(f) for f in flags), jnp.asarray(THRESHOLDS), jax.random.PRNGKey(0),
        jnp.asarray(do_ema))
    return {"metrics": {k: np.asarray(v) for k, v in metrics.items()},
            "counts": np.asarray(counts),
            "grads": from_flax(jax.tree.map(np.asarray, new_state.opt_state[0]), {}),
            "params": from_flax(jax.tree.map(np.asarray, new_state.params), frozen),
            "teacher": from_flax(jax.tree.map(np.asarray, new_ema), frozen)}


def _port_step(kind, n_labeled, params, teacher, frozen, batch, do_ema):
    tcfg = _configs(TConfig)
    model, wd = build_model(tcfg, device="cpu")
    model.load_state_dict(from_flax(params, frozen), strict=True)
    state = engine.init_train_state(model, tcfg, STEPS_PER_EPOCH, schedule="cosine")
    tea = engine.make_teacher(model)
    tea.load_state_dict(from_flax(teacher, frozen), strict=True)
    before = {"params": {k: v.clone() for k, v in model.state_dict().items()},
              "teacher": {k: v.clone() for k, v in tea.state_dict().items()}}
    grads = {}
    real_step = state.optimizer.step

    def keep_grads():  # the gradients, before the update zeroes them
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        real_step()

    state.optimizer.step = keep_grads
    step = engine.make_semi_train_step(wd, tcfg, n_labeled=n_labeled, device="cpu", **kind)
    feats, noisy, pad, targets, flags = batch
    t = lambda x: torch.from_numpy(np.asarray(x))
    metrics, counts = step(state, tea, t(feats), t(noisy), t(pad),
                           DenseTargets(*(t(x) for x in targets)), *(t(f) for f in flags),
                           t(THRESHOLDS), torch.Generator().manual_seed(0), do_ema)
    return {"metrics": metrics, "counts": counts.numpy(), "grads": grads,
            "params": model.state_dict(), "teacher": tea.state_dict(), "before": before,
            "named": dict(model.named_parameters())}


@pytest.fixture(scope="module", params=list(KINDS))
def both(request, weights_and_batch):
    """One step of each package, with the EMA."""
    kind, n_labeled = KINDS[request.param]
    params, teacher, frozen, batch = weights_and_batch
    want = _jax_step(kind, n_labeled, params, teacher, frozen, batch, True)
    got = _port_step(kind, n_labeled, params, teacher, frozen, batch, True)
    return request.param, want, got


def test_losses_and_terms_match_jax(both):
    _, want, got = both
    assert set(got["metrics"]) == set(want["metrics"])
    assert {"sup_loss_ce", "unsup_loss_ce", "sup_loss_weak", "unsup_loss_bbox_0"} <= set(
        got["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), w, err_msg=k, **TOL)


def test_pseudo_counts_match_jax_exactly(both):
    _, want, got = both
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["counts"].sum() > 0 and got["counts"].dtype == np.float32


def test_updated_student_matches_jax(both):
    """The AdamW update on the entries that the two gradients pin; the rest
    within Adam's bound (``test_torch_train_step``'s rule)."""
    _, want, got = both
    tcfg = TConfig.tiny_test().train
    lr, wd = tcfg.lr, tcfg.weight_decay
    trainable = [n for n in want["grads"] if param_label(n) != "frozen"]
    assert set(got["grads"]) == set(trainable)
    norm = float(np.sqrt(sum((want["grads"][n].numpy().astype(np.float64) ** 2).sum()
                             for n in trainable)))
    eps = 1e-8 / min(1.0, tcfg.clip_max_norm / norm)
    n_live = n_all = 0
    for name in trainable:
        g, g_got = want["grads"][name].numpy(), got["grads"][name].numpy()
        w, p = want["params"][name].numpy(), got["params"][name].numpy()
        apart = eps * np.abs(g_got - g) / ((np.abs(g) + eps) * (np.abs(g_got) + eps))
        both_zero = (g == 0) & (g_got == 0)
        live = (((np.abs(g) >= 1e-6 * np.abs(g).max()) | both_zero)
                & (np.sign(g) == np.sign(g_got)) & (apart <= 1e-4))
        np.testing.assert_allclose(p[live], w[live], rtol=2.5e-7, atol=2e-8, err_msg=name)
        bound = 2 * lr * (1 + wd * np.abs(got["before"]["params"][name].numpy())) + 1e-7
        assert (np.abs(p - w) <= bound).all(), name
        n_live += int(live.sum())
        n_all += live.size
    assert n_live > 0.9 * n_all, (n_live, n_all)
    for name, p in got["named"].items():  # frozen leaves and buffers bit for bit
        if not p.requires_grad:
            assert torch.equal(p.detach(), got["before"]["params"][name]), name
    for name, b in got["params"].items():
        if name not in got["named"]:
            assert torch.equal(b, got["before"]["params"][name]), name


def test_teacher_follows_the_ema_of_every_parameter(both):
    """d * teacher + (1 - d) * student on every parameter, the frozen ones
    included: the port's teacher against JAX's new EMA tree, apart by at
    most (1 - d) times the two students' difference and two f32
    roundings; the FrozenBN buffers as they were."""
    _, want, got = both
    d = TConfig.tiny_test().train.ema_decay
    labels = {name: param_label(name) for name in got["named"]}
    for name in got["named"]:
        t, w = got["teacher"][name].numpy(), want["teacher"][name].numpy()
        gap = (1 - d) * np.abs(got["params"][name].numpy() - want["params"][name].numpy())
        assert (np.abs(t - w) <= gap + 2.5e-7 * np.abs(w) + 1e-12).all(), name
    main = [n for n, label in labels.items() if label == "main"]
    moved = [n for n in main if not torch.equal(got["teacher"][n], got["before"]["teacher"][n])]
    assert "frozen" in labels.values() and len(moved) > 0.9 * len(main), (len(moved), len(main))
    for name, b in got["teacher"].items():
        if name not in got["named"]:
            assert torch.equal(b, got["before"]["teacher"][name]), name


def test_teacher_without_ema_is_unchanged(weights_and_batch):
    """``do_ema`` False: the student steps, the teacher stays bit for bit."""
    params, teacher, frozen, batch = weights_and_batch
    got = _port_step({}, N_LAB, params, teacher, frozen, batch, False)
    for name, v in got["teacher"].items():
        assert torch.equal(v, got["before"]["teacher"][name]), name
    assert not torch.equal(got["params"]["class_embed.weight"],
                           got["before"]["params"]["class_embed.weight"])
