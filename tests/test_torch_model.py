"""SEDT forward of the PyTorch port against the JAX package on transferred
weights (``weights.from_flax`` of one JAX init, FrozenBN statistics drawn
with numpy), f32 at the tiny test geometry.

Tolerance atol 1e-4, rtol 1e-4: f32 convolution and matmul sums run in a
different order on the two sides."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models import resnet as jresnet
from sound_event_detection_transformer_tpu.models import sedt as jsedt
from sound_event_detection_transformer_tpu.models.transformer import Transformer as JTransformer
from sound_event_detection_transformer_tpu.ops.attention import make_key_padding_bias as jbias
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.models import build_model as tbuild
from sound_event_detection_transformer_tpu_torch.models import resnet as tresnet
from sound_event_detection_transformer_tpu_torch.models import sedt as tsedt
from sound_event_detection_transformer_tpu_torch.models.transformer import Transformer as TTransformer
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
B = 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def _random_frozen(frozen, rng):
    """FrozenBN statistics away from the identity, so the fold is exercised;
    scales below 1 keep the activations of a he_normal trunk near unit size,
    as trained statistics do."""
    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.2, 0.5, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, frozen)


@pytest.fixture(scope="module")
def tiny():
    """One JAX init of the tiny SEDT, reused by every test of this file."""
    cfg = JConfig.tiny_test()
    model, _ = jbuild(cfg)
    rng = np.random.RandomState(0)
    T, F = cfg.model.max_frames, cfg.model.n_mels
    feats = rng.randn(B, T, F, 1).astype(np.float32)
    zeros = jnp.zeros((B, T), bool)
    v = jax.jit(lambda r: model.init({"params": r}, jnp.asarray(feats), zeros, True))(
        jax.random.PRNGKey(0))
    params = _np_tree(v["params"])
    frozen = _random_frozen(_np_tree(v["frozen"]), rng)
    return cfg, params, frozen, feats


def _sub(tree, key):
    return tree[key] if key in tree else {}


@pytest.mark.parametrize("dilation", [True, False], ids=["dc", "plain"])
def test_resnet18_backbone(tiny, dilation):
    _, params, frozen, feats = tiny
    p, f = params["backbone"], frozen["backbone"]
    want = jresnet.ResNetBackbone("resnet18", dilation).apply(
        {"params": p, "frozen": f}, jnp.asarray(feats))
    net = tresnet.ResNetBackbone("resnet18", dilation)
    net.load_state_dict(from_flax(p, f), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(feats))
    assert got.shape == want.shape
    assert 0.1 < float(got.abs().max()) < 20.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_resnet50_bottleneck(stride, dilation):
    rng = np.random.RandomState(stride * 10 + dilation)
    x = rng.randn(B, 16, 8, 64).astype(np.float32)
    block = jresnet.Bottleneck(planes=32, stride=stride, dilation=dilation, downsample=True)
    v = block.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params, frozen = _np_tree(v["params"]), _random_frozen(_np_tree(v["frozen"]), rng)
    want = block.apply({"params": params, "frozen": frozen}, jnp.asarray(x))
    net = tresnet.Bottleneck(64, 32, stride=stride, dilation=dilation, downsample=True)
    net.load_state_dict(from_flax(params, frozen), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transformer(tiny):
    cfg, params, _, _ = tiny
    m = cfg.model
    rng = np.random.RandomState(2)
    S, nq, D = 12, m.num_queries + 1, m.hidden_dim
    src, pos = (rng.randn(B, S, D).astype(np.float32) for _ in range(2))
    query = rng.randn(B, nq, D).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, 9:] = True
    jt = JTransformer(D, m.nheads, m.enc_layers, m.dec_layers, m.dim_feedforward, 0.0)
    hs, mem = jt.apply({"params": params["transformer"]}, jnp.asarray(src), jnp.asarray(pos),
                       jbias(jnp.asarray(pad)), jnp.asarray(query))
    tt = TTransformer(D, m.nheads, m.enc_layers, m.dec_layers, m.dim_feedforward)
    tt.load_state_dict(from_flax(params["transformer"], {}), strict=True)
    bias = torch.zeros(B, 1, 1, S).masked_fill(torch.from_numpy(pad)[:, None, None], -1e9)
    with torch.no_grad():
        ths, tmem = tt(torch.from_numpy(src), torch.from_numpy(pos), bias, torch.from_numpy(query))
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), **TOL)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(mem), **TOL)


def _sedt_pair(cfg_j, params, frozen):
    jm, _ = jbuild(cfg_j)
    tcfg = TConfig.tiny_test()
    tcfg = tcfg.replace(model=dataclasses.replace(
        tcfg.model, pooling=cfg_j.model.pooling,
        position_embedding=cfg_j.model.position_embedding))
    tm, _ = tbuild(tcfg, device="cpu")
    tm.load_state_dict(from_flax(params, frozen), strict=True)
    return jm, tm


def _compare(jm, tm, params, frozen, feats, pad):
    want = jax.jit(lambda f, p: jm.apply({"params": params, "frozen": frozen}, f, p, True))(
        jnp.asarray(feats), jnp.asarray(pad))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(pad))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_sedt_forward_all_keys(tiny):
    """Both pad masks through one model: none, and a padded tail."""
    cfg, params, frozen, feats = tiny
    jm, tm = _sedt_pair(cfg, params, frozen)
    pad = np.zeros((B, cfg.model.max_frames), bool)
    _compare(jm, tm, params, frozen, feats, pad)
    pad[1, 93:] = True  # a tail that ends between feature-grid cells
    _compare(jm, tm, params, frozen, feats, pad)


def test_sedt_attn_pooling_learned_positions(tiny):
    cfg, params, frozen, feats = tiny
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, pooling="attn", position_embedding="learned"))
    rng = np.random.RandomState(3)
    D, C = cfg.model.hidden_dim, cfg.model.num_classes
    params = dict(params)
    params["attn_dense_softmax"] = {"kernel": rng.randn(D, C).astype(np.float32) * 0.1,
                                    "bias": rng.randn(C).astype(np.float32) * 0.1}
    params["pos_embed_learned"] = {"row_embed": {"embedding": rng.rand(50, D).astype(np.float32)}}
    jm, tm = _sedt_pair(cfg, params, frozen)
    pad = np.zeros((B, cfg.model.max_frames), bool)
    pad[0, 70:] = True
    _compare(jm, tm, params, frozen, feats, pad)


@pytest.mark.parametrize("t,t_out", [(128, 8), (500, 32), (496, 31), (7, 3)])
def test_downsample_mask_half_pixel_nearest(t, t_out):
    """A padded tail resized as jax.image.resize 'nearest' does."""
    pad = np.zeros((3, t), bool)
    pad[1, t // 2 + 1:] = True
    pad[2, t - 3:] = True
    want = jsedt.downsample_mask(jnp.asarray(pad), t_out, 4)
    got = tsedt.downsample_mask(torch.from_numpy(pad), t_out, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
