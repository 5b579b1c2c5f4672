"""Box ops and matcher of the PyTorch port against the JAX package, on the
same numpy inputs (f32; box ops to 1e-6, costs to 1e-5).  Assignments are
compared by optimal cost, since ties may pick different indices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.ops import box_ops as jbox
from sound_event_detection_transformer_tpu.ops import matcher as jmatcher
from sound_event_detection_transformer_tpu_torch.ops import box_ops as tbox
from sound_event_detection_transformer_tpu_torch.ops import matcher as tmatcher

torch.set_num_threads(2)


def _boxes(rng, *shape):
    """(center, length) boxes with positive lengths."""
    c = rng.uniform(0.0, 1.0, shape)
    l = rng.uniform(0.01, 0.5, shape)
    return np.stack([c, l], -1).astype(np.float32)


UNARY = ["box_cl_to_se", "box_se_to_cl", "box_length"]
ALIGNED = ["elementwise_l1_se", "elementwise_giou_se"]
PAIRWISE = ["box_iou", "generalized_box_iou", "pairwise_l1_se"]


@pytest.mark.parametrize("name", UNARY + ALIGNED + PAIRWISE)
def test_box_ops_match_jax(name):
    rng = np.random.RandomState(len(name))
    se = lambda *shape: np.array(jbox.box_cl_to_se(_boxes(rng, *shape)))
    if name in UNARY:
        args = (_boxes(rng, 3, 7),)
    elif name in ALIGNED:
        args = (se(3, 7), se(3, 7))
    else:
        args = (se(3, 7), se(3, 5))
    want = jax.tree.leaves(getattr(jbox, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tbox, name)(*(torch.from_numpy(x) for x in args))
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def _problem(rng, b, q, m, c=5):
    logits = rng.randn(b, q, c + 1).astype(np.float32)
    boxes = _boxes(rng, b, q)
    labels = rng.randint(0, c, (b, m)).astype(np.int32)
    tboxes = _boxes(rng, b, m)
    valid = rng.rand(b, m) < 0.7
    valid[:, 0] = True
    return logits, boxes, labels, tboxes, valid


@pytest.mark.parametrize("focal", [False, True])
def test_cost_matrix_matches_jax(focal):
    rng = np.random.RandomState(int(focal))
    args = _problem(rng, 4, 10, 20)
    kw = dict(cost_class=1.0, cost_bbox=5.0, cost_giou=2.0, focal=focal,
              alpha_fl=0.5, gamma_fl=1.0)
    want = jmatcher.compute_cost_matrix(*(jnp.asarray(x) for x in args), **kw)
    got = tmatcher.compute_cost_matrix(*(torch.from_numpy(x) for x in args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _pairs(res, b):
    """(query, target) pairs of sample b, from either package's MatchResult."""
    return [(q, t) for q, t in enumerate(np.asarray(res.tgt_for_query[b]).tolist()) if t >= 0]


@pytest.mark.parametrize("q,m", [(10, 20), (9, 4), (6, 6)])
def test_match_and_assign_match_jax(q, m):
    rng = np.random.RandomState(q * 100 + m)
    B = 5
    logits, boxes, labels, tboxes, valid = _problem(rng, B, q, m)
    ratio = rng.uniform(0.2, 1.0, (B, m)).astype(np.float32)
    want = jmatcher.match(*(jnp.asarray(x) for x in (logits, boxes, labels, tboxes, valid)),
                          tgt_ratio=jnp.asarray(ratio))
    got = tmatcher.match(*(torch.from_numpy(x) for x in (logits, boxes, labels, tboxes, valid)),
                         tgt_ratio=torch.from_numpy(ratio))
    cost = np.asarray(jmatcher.compute_cost_matrix(
        *(jnp.asarray(x) for x in (logits, boxes, labels, tboxes, valid)), 1.0, 5.0, 2.0))
    for b in range(B):
        ours, theirs = _pairs(got, b), _pairs(want, b)
        assert len(ours) == len(theirs) == min(q, int(valid[b].sum()))
        c_ours = sum(cost[b, i, t] for i, t in ours)
        c_theirs = sum(cost[b, i, t] for i, t in theirs)
        assert abs(c_ours - c_theirs) <= 1e-2 * max(1.0, abs(c_theirs))
        # forward and inverse mappings agree
        for i, t in ours:
            assert valid[b, t] and got.query_for_tgt[b, t] == i and got.tgt_matched[b, t]
            assert got.coef[b, i] == pytest.approx(ratio[b, t])
        assert int(got.tgt_matched[b].sum()) == len(ours)
        assert not got.query_matched[b][[i for i in range(q) if i not in dict(ours)]].any()
    np.testing.assert_allclose(got.num_boxes.numpy(), np.asarray(want.num_boxes), rtol=1e-5)


@pytest.mark.parametrize("q,m", [(4, 9), (9, 4)])
def test_assign_orientations_match_jax(q, m):
    rng = np.random.RandomState(q + m)
    costs = rng.randn(3, q, m).astype(np.float32)
    valid = rng.rand(3, m) < 0.7
    valid[:, 0] = True
    masked = np.where(valid[:, None, :], costs, jmatcher.BIG).astype(np.float32)
    t4q, qm, q4t, tm = (x.numpy() for x in tmatcher.assign(torch.from_numpy(masked),
                                                           torch.from_numpy(valid)))
    j4q, jqm, _, _ = (np.asarray(x) for x in jmatcher.assign(jnp.asarray(masked),
                                                               jnp.asarray(valid)))
    for b in range(3):
        ours = [(i, t4q[b, i]) for i in range(q) if qm[b, i]]
        theirs = [(i, j4q[b, i]) for i in range(q) if jqm[b, i]]
        assert len(ours) == len(theirs)
        sc = sum(masked[b, i, t] for i, t in theirs)
        assert abs(sum(masked[b, i, t] for i, t in ours) - sc) <= 1e-2 * max(1.0, abs(sc))
        for i, t in ours:
            assert q4t[b, t] == i and tm[b, t]


def test_fine_tune_waits_for_training_slice():
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(x) for x in _problem(rng, 2, 4, 3)]
    with pytest.raises(NotImplementedError):
        tmatcher.match(*args, fine_tune=True)
