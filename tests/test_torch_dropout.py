"""Dropout of the PyTorch port: ``ops/dropout.dropout``, the attention
dropout and the dropout sites of the transformer.

The two packages draw their masks from different streams (threefry against
Philox), so they are compared module by module at rate 1.0, where both are
deterministic: every element is dropped, and JAX's ``jnp.where`` never
selects its x / 0.  The biases are drawn away from zero so that what remains
of each module is not zero.  Tolerance atol 1e-5, rtol 1e-5 (f32).  At
rate 0.1 the keep share is held to 5 standard deviations of a binomial
share, and a seed must give the same mask again.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.models import transformer as jtr
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.models import transformer as ttr
from sound_event_detection_transformer_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ,
    scaled_dot_attention,
)
from sound_event_detection_transformer_tpu_torch.ops.dropout import dropout
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, Q, D, H, FF = 2, 7, 5, 16, 4, 24


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_identity_when_deterministic_or_rate_zero():
    x = torch.randn(3, 4, generator=_gen(0))
    assert dropout(x, 0.1, _gen(1), deterministic=True) is x
    assert dropout(x, 0.0, _gen(1), deterministic=False) is x
    assert dropout(x, 0.1, None, deterministic=True) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, None, deterministic=False)


def test_keep_share_and_scale_at_rate_0_1():
    n = 200_000
    x = torch.ones(n, requires_grad=True)
    y = dropout(x, 0.1, _gen(3), deterministic=False)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / n) ** 0.5, share
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    y.sum().backward()  # the gradient is the mask, scaled
    torch.testing.assert_close(x.grad, kept.float() / 0.9)


def test_same_seed_same_mask():
    x = torch.randn(64, 33, generator=_gen(0))
    a = dropout(x, 0.3, _gen(7), deterministic=False)
    b = dropout(x, 0.3, _gen(7), deterministic=False)
    c = dropout(x, 0.3, _gen(8), deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_rate_one_drops_everything_with_a_finite_gradient():
    x = torch.randn(5, 6, generator=_gen(0), requires_grad=True)
    y = dropout(x, 1.0, _gen(1), deterministic=False)
    assert torch.equal(y, torch.zeros_like(y))
    y.sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_attention_dropout_is_on_the_probabilities():
    """Any dropout takes the plain path, long keys too; the rows of the
    dropped probabilities are rescaled, so at rate 0.5 the output is the
    plain output's where half the keys' weights double."""
    g = _gen(0)
    q = torch.randn(2, 2, 3, 8, generator=g)
    k = torch.randn(2, 2, FLASH_MIN_SEQ, 8, generator=g)
    v = torch.ones(2, 2, FLASH_MIN_SEQ, 8)
    out = scaled_dot_attention(q, k, v, dropout_rate=0.5, generator=_gen(4))
    again = scaled_dot_attention(q, k, v, dropout_rate=0.5, generator=_gen(4))
    assert torch.equal(out, again)
    # with v all ones, each output is the kept probabilities' sum / 0.5: about 1
    assert out.shape == q.shape and 0.7 < float(out.mean()) < 1.3
    assert torch.equal(scaled_dot_attention(q, k, v, dropout_rate=1.0, generator=_gen(4)),
                       torch.zeros_like(out))


def _biases_away_from_zero(tree, rng):
    def draw(path, x):
        if path[-1].key == "bias":
            return (rng.uniform(0.5, 1.5, x.shape) * rng.choice([-1, 1], x.shape)).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _modules():
    """(name, JAX module, port module, inputs builder) at rate 1.0."""
    return {
        "attention": (jtr.MultiHeadAttention(D, H, 1.0), ttr.MultiHeadAttention(D, H, 1.0),
                      lambda r: (r.randn(B, Q, D), r.randn(B, S, D), r.randn(B, S, D))),
        "ffn": (jtr.FFN(D, FF, 1.0), ttr.FFN(D, FF, 1.0), lambda r: (r.randn(B, S, D),)),
        "encoder_pre_norm": (jtr.EncoderLayer(D, H, FF, 1.0), ttr.EncoderLayer(D, H, FF, 1.0),
                             lambda r: (r.randn(B, S, D), r.randn(B, S, D), None)),
        "encoder_post_norm": (jtr.EncoderLayer(D, H, FF, 1.0, pre_norm=False),
                              ttr.EncoderLayer(D, H, FF, 1.0, pre_norm=False),
                              lambda r: (r.randn(B, S, D), r.randn(B, S, D), None)),
        "decoder_pre_norm": (jtr.DecoderLayer(D, H, FF, 1.0), ttr.DecoderLayer(D, H, FF, 1.0),
                             lambda r: (r.randn(B, Q, D), r.randn(B, S, D), r.randn(B, Q, D),
                                        r.randn(B, S, D), None, None)),
        "decoder_post_norm": (jtr.DecoderLayer(D, H, FF, 1.0, pre_norm=False),
                              ttr.DecoderLayer(D, H, FF, 1.0, pre_norm=False),
                              lambda r: (r.randn(B, Q, D), r.randn(B, S, D), r.randn(B, Q, D),
                                         r.randn(B, S, D), None, None)),
    }


@pytest.mark.parametrize("name", list(_modules()))
def test_modules_at_rate_one_match_jax(name):
    jmod, tmod, inputs = _modules()[name]
    rng = np.random.RandomState(len(name))
    args = [None if a is None else a.astype(np.float32) for a in inputs(rng)]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = flax.core.unfreeze(jmod.init(jax.random.PRNGKey(0), *jargs)["params"])
    params = _biases_away_from_zero(params, rng)
    outs = [np.asarray(jmod.apply({"params": params}, *jargs, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(seed)}))
            for seed in (1, 2)]
    np.testing.assert_array_equal(outs[0], outs[1])  # rate 1.0: no key matters
    assert np.isfinite(outs[0]).all() and np.abs(outs[0]).max() > 0.1
    tmod.load_state_dict(from_flax(params, {}), strict=True)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    with torch.no_grad():
        got = tmod(*targs, deterministic=False, generator=_gen(0))
    np.testing.assert_allclose(got.numpy(), outs[0], **TOL)


def test_model_dropout_follows_the_argument_not_the_mode():
    """``build_model`` returns the model in eval mode; dropout is decided by
    ``deterministic`` alone, and a seed fixes its masks."""
    cfg = SEDTConfig.tiny_test()
    model, _ = build_model(cfg, device="cpu", generator=_gen(0))
    assert not model.training
    m = cfg.model
    feats = torch.randn(2, m.max_frames, m.n_mels, 1, generator=_gen(1))
    pad = torch.zeros(2, m.max_frames, dtype=torch.bool)
    with torch.no_grad():
        plain = model(feats, pad)["pred_logits"]
        drop = [model(feats, pad, deterministic=False, generator=_gen(s))["pred_logits"]
                for s in (5, 5, 6)]
        model.train()
        assert torch.equal(model(feats, pad)["pred_logits"], plain)
        assert torch.equal(model(feats, pad, deterministic=False, generator=_gen(5))["pred_logits"],
                           drop[0])
    assert torch.equal(drop[0], drop[1])
    assert not torch.equal(drop[0], drop[2]) and not torch.equal(drop[0], plain)
