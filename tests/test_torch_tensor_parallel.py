"""The port's tensor-parallel layout over the model axis, without a process
group: ``parallel.mesh.param_spec`` against the JAX package's
``param_sharding`` leaf by leaf (through ``weights.from_flax``'s names) on
its 8-device CPU mesh for the tiny SEDT, SP-SEDT and audio-tag backbone;
the "only where it divides" rule on both sides; the raise for heads that do
not divide; ``shard_state_dict`` and ``shard_model`` cut and put back bit
for bit; and the split math of the attention and the FFN: two rank-local
modules whose row-split outputs are summed by hand and the bias added once
give the whole module's output and gradients (f32, to 1e-6), dropout
included, whose sliced masks tile the whole module's mask exactly.
``layout_shape`` and ``default_mesh`` against ``make_mesh`` and the JAX
dryrun's rule.
"""
import copy
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu.config import MeshConfig as JMesh
from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu.models.resnet import AudioTagBackbone as JAudioTag
from sound_event_detection_transformer_tpu.parallel.mesh import make_mesh, param_sharding
from sound_event_detection_transformer_tpu_torch.config import MeshConfig
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.models import AudioTagBackbone, build_model
from sound_event_detection_transformer_tpu_torch.models.transformer import FFN, MultiHeadAttention
from sound_event_detection_transformer_tpu_torch.ops.dropout import dropout
from sound_event_detection_transformer_tpu_torch.parallel import mesh as tmesh
from sound_event_detection_transformer_tpu_torch.parallel.distribute import layout_shape
from sound_event_detection_transformer_tpu_torch.parallel.dryrun import default_mesh
from sound_event_detection_transformer_tpu_torch.parallel.optim import clip_by_global_norm_
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
P = 3  # SP-SEDT patches


def _configs(cfg_cls, **model_kw):
    cfg = cfg_cls.tiny_test()
    return cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))


def _spsedt(cfg_cls, **model_kw):
    return _configs(cfg_cls, self_sup=True, dec_at=False, num_queries=6, num_patches=P,
                    feature_recon=True, **model_kw)


def _jax_shapes(kind, jcfg):
    """The JAX model's parameter tree as shapes (``jax.eval_shape``, no
    compute)."""
    m = jcfg.model
    feats = jnp.zeros((1, m.max_frames, m.n_mels, 1))
    pad = jnp.zeros((1, m.max_frames), bool)
    if kind == "audio_tag":
        jmodel = JAudioTag("resnet18", True, "avg", m.num_classes, logits_out=True)
        return jax.eval_shape(lambda r: jmodel.init({"params": r}, feats), jax.random.PRNGKey(0))
    jmodel, _ = jbuild(jcfg)
    extra = (jnp.zeros((1, P, 128, 64, 1)),) if kind == "spsedt" else ()
    rngs = ("params", "dropout", "patch_mask")
    return jax.eval_shape(lambda r: jmodel.init({k: r for k in rngs}, feats, pad, *extra, True),
                          jax.random.PRNGKey(0))


def _jax_spec(shapes, n_model):
    """``param_sharding`` on a (8 / n_model, n_model) mesh, mapped onto the
    port's names: ``{torch name: the torch dim over model, or None}`` (a
    Dense kernel [in, out] is a Linear weight [out, in])."""
    params = shapes["params"]
    sh = param_sharding(params, make_mesh(JMesh(n_model=n_model)))
    spec = {}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for (path, leaf), s in zip(flat, jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))):
        keys = tuple(p.key for p in path)
        name = next(iter(from_flax({"x": _nest(keys, np.zeros(leaf.shape, np.float32))}, {})))
        name = name[2:]  # drop the "x." root
        axes = [i for i, ax in enumerate(s.spec) if ax == "model"]
        dim = axes[0] if axes else None
        if dim is not None and keys[-1] == "kernel" and len(leaf.shape) == 2:
            dim = 1 - dim
        spec[name] = dim
    return spec


def _nest(keys, value):
    out = value
    for k in reversed(keys):
        out = {k: out}
    return out


def _port_model(kind, tcfg):
    if kind == "audio_tag":
        return AudioTagBackbone("resnet18", True, "avg", tcfg.model.num_classes, logits_out=True)
    return build_model(tcfg, device="cpu")[0]


KINDS = {"sedt": _configs, "spsedt": _spsedt, "audio_tag": _configs}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_param_spec_matches_jax_param_sharding(kind):
    jcfg, tcfg = KINDS[kind](JConfig), KINDS[kind](TConfig)
    want = _jax_spec(_jax_shapes(kind, jcfg), 2)
    got = tmesh.param_spec(_port_model(kind, tcfg), 2)
    assert got == want
    n_cut = sum(d is not None for d in got.values())
    if kind == "audio_tag":
        assert n_cut == 0  # no transformer: everything replicated
    else:  # q/k/v weight + bias, out_proj weight per attention; linear1 w + b, linear2 w per FFN
        m = tcfg.model
        n_attn = m.enc_layers + 2 * m.dec_layers
        assert n_cut == 7 * n_attn + 3 * (m.enc_layers + m.dec_layers)


def test_a_dim_that_does_not_divide_is_replicated_on_both_sides():
    """FFN 129 wide over 2 model ranks: the FFN stays whole on both sides,
    the attention (64 wide, 4 heads) is cut."""
    jcfg, tcfg = _configs(JConfig, dim_feedforward=129), _configs(TConfig, dim_feedforward=129)
    want = _jax_spec(_jax_shapes("sedt", jcfg), 2)
    model = _port_model("sedt", tcfg)
    got = tmesh.param_spec(model, 2)
    assert got == want
    assert all(d is None for n, d in got.items() if ".ffn." in n)
    assert got["transformer.encoder_layer_0.self_attn.q_proj.weight"] == 0
    tmesh.shard_model(model, 2, 1)
    layer = model.transformer.encoder_layer_0
    assert layer.ffn.model_parts == 1 and layer.ffn.linear1.weight.shape == (129, 64)
    assert layer.self_attn.model_parts == 2 and layer.self_attn.model_index == 1
    assert layer.self_attn.q_proj.weight.shape == (32, 64)


def test_heads_that_do_not_divide_raise():
    """4 heads of 16 over 8 model ranks: JAX cuts the 64-wide projections
    (GSPMD may split inside a head), the port raises."""
    want = _jax_spec(_jax_shapes("sedt", _configs(JConfig)), 8)
    assert want["transformer.encoder_layer_0.self_attn.q_proj.weight"] == 0
    model = _port_model("sedt", _configs(TConfig))
    with pytest.raises(ValueError, match="heads do not divide"):
        tmesh.param_spec(model, 8)
    with pytest.raises(ValueError, match="heads do not divide"):
        tmesh.shard_model(model, 8, 0)


def test_nothing_is_cut_at_one_model_rank():
    model = _port_model("sedt", _configs(TConfig))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    spec = tmesh.shard_model(model, 1, 0)
    assert all(d is None for d in spec.values())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(getattr(m, "model_parts", 1) == 1 for m in model.modules())


def test_shard_state_dict_then_reassembly_is_the_whole_state():
    model = build_model(_configs(TConfig), device="cpu",
                        generator=torch.Generator().manual_seed(0))[0]
    full = model.state_dict()
    spec = tmesh.param_spec(model, 2)
    parts = [tmesh.shard_state_dict(full, spec, r, 2) for r in range(2)]
    for name, t in full.items():
        dim = spec.get(name)
        if dim is None:
            assert all(p[name] is t for p in parts)
            continue
        assert parts[0][name].shape[dim] * 2 == t.shape[dim]
        assert torch.equal(torch.cat([p[name] for p in parts], dim), t), name
    for r in range(2):  # a cut model holds exactly rank r's part, flagged for the clip
        cut = copy.deepcopy(model)
        tmesh.shard_model(cut, 2, r)
        got = cut.state_dict()
        assert got.keys() == parts[r].keys()
        assert all(torch.equal(got[k], v) for k, v in parts[r].items())
        flagged = {n for n, p in cut.named_parameters() if hasattr(p, "model_shard_dim")}
        assert flagged == {n for n, d in spec.items() if d is not None}


def test_jax_weights_load_into_each_model_rank():
    """``from_flax`` of one JAX init, cut by ``shard_state_dict``, loads strictly into the port's
    model cut for each rank, and the two parts put back are ``from_flax``'s."""
    jcfg, tcfg = _configs(JConfig), _configs(TConfig)
    jmodel, _ = jbuild(jcfg)
    m = jcfg.model
    v = jax.jit(lambda r: jmodel.init({"params": r, "dropout": r},
                                      jnp.zeros((1, m.max_frames, m.n_mels, 1)),
                                      jnp.zeros((1, m.max_frames), bool), True))(
        jax.random.PRNGKey(2))
    params, frozen = (jax.tree.map(np.asarray, flax.core.unfreeze(v[k]))
                      for k in ("params", "frozen"))
    whole = from_flax(params, frozen)
    spec = tmesh.param_spec(build_model(tcfg, device="cpu")[0], 2)
    loaded = []
    for r in range(2):
        model = build_model(tcfg, device="cpu")[0]
        tmesh.shard_model(model, 2, r)
        model.load_state_dict(tmesh.shard_state_dict(whole, spec, r, 2), strict=True)
        loaded.append(model.state_dict())
    for name, t in whole.items():
        dim = spec.get(name)
        got = loaded[0][name] if dim is None else torch.cat([s[name] for s in loaded], dim)
        assert torch.equal(got, t), name


class _Layer(torch.nn.Module):
    """An attention and an FFN under the names the rules look for."""

    def __init__(self, d=32, heads=4, ff=48, rate=0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads, rate)
        self.ffn = FFN(d, ff, rate)
        with torch.no_grad():  # biases away from their zero init, so that one counted twice shows
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.normal_()


def _split_pair(layer, n=2):
    parts = []
    for r in range(n):
        part = copy.deepcopy(layer)
        tmesh.shard_model(part, n, r)
        parts.append(part)
    return parts


def _by_hand(outs, bias):
    """The ranks' row-split outputs summed, the bias added once: without a
    group each rank's module returns its partial product plus the bias."""
    return sum(outs) - (len(outs) - 1) * bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("which", ["self_attn", "cross_attn", "ffn"])
def test_split_math_matches_the_whole_module(which, rate):
    """Two rank-local modules against the whole one: outputs, the input
    gradients summed over the ranks (``copy_to_model``'s all_reduce) and the
    parameter gradients rank by rank (the slices of the whole ones; the
    row-split bias's whole), f32 to 1e-6.  At rate 0.1 every module draws from a generator of one seed, so
    the ranks' sliced masks are the whole module's."""
    torch.manual_seed(0)
    layer = _Layer(rate=rate)
    parts = _split_pair(layer)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
    mem = torch.from_numpy(rng.randn(3, 7, 32).astype(np.float32))
    r = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32))
    bias = torch.zeros(3, 1, 1, 7)
    bias[1, ..., 5:] = -1e9  # padded keys on one row

    def run(mod):
        xi, mi = x.clone().requires_grad_(), mem.clone().requires_grad_()
        gen = torch.Generator().manual_seed(7)
        kw = dict(deterministic=rate == 0.0, generator=gen)
        if which == "ffn":
            out = mod.ffn(xi, **kw)
        elif which == "self_attn":
            out = mod.self_attn(xi, xi, xi, **kw)
        else:
            out = mod.self_attn(xi, mi, mi, bias, **kw)
        return out, xi, mi

    want, xw, mw = run(layer)
    (want * r).sum().backward()
    outs = [run(p) for p in parts]
    row_bias = (layer.ffn.linear2 if which == "ffn" else layer.self_attn.out_proj).bias
    got = _by_hand([o for o, _, _ in outs], row_bias.detach())
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    (got * r).sum().backward()
    for ref, i in ((xw, 1), (mw, 2)):
        if ref.grad is not None:
            torch.testing.assert_close(sum(o[i].grad for o in outs), ref.grad, atol=1e-6,
                                       rtol=1e-6)
    spec = tmesh.param_spec(layer, 2)
    whole = dict(layer.named_parameters())
    for k, part in enumerate(parts):
        for name, p in part.named_parameters():
            if whole[name].grad is None:
                continue
            # a cut parameter's gradient is its slice of the whole one; the
            # row-split bias, added once to the replicated sum, gets the
            # whole gradient on every rank
            dim = spec[name]
            want_g = whole[name].grad if dim is None else whole[name].grad.chunk(2, dim)[k]
            torch.testing.assert_close(p.grad, want_g, atol=1e-6, rtol=1e-6, msg=name)


def test_row_split_bias_added_on_every_rank_is_caught():
    """The trap the split math guards against: adding the row-split bias on
    both ranks before the sum counts it twice."""
    torch.manual_seed(0)
    layer = _Layer()
    parts = _split_pair(layer)
    x = torch.randn(2, 4, 32)
    want = layer.ffn(x)
    twice = sum(p.ffn(x) for p in parts)
    assert not torch.allclose(twice, want, atol=1e-3)
    torch.testing.assert_close(_by_hand([p.ffn(x) for p in parts], layer.ffn.linear2.bias),
                               want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dim", [1, -1])
def test_sliced_dropout_masks_tile_the_whole_mask(dim):
    """``dropout(shard=(dim, r, 2))`` on each half from generators of one
    seed, put back, is exactly the whole tensor's dropout; per-rank seeds
    would give other masks."""
    whole = torch.ones(3, 4, 6, 8)
    want = dropout(whole, 0.1, torch.Generator().manual_seed(3), False)
    halves = whole.chunk(2, dim)
    got = torch.cat([dropout(h, 0.1, torch.Generator().manual_seed(3), False,
                             shard=(dim, r, 2)) for r, h in enumerate(halves)], dim)
    assert torch.equal(got, want)
    other = torch.cat([dropout(h, 0.1, torch.Generator().manual_seed(3 + r), False,
                               shard=(dim, r, 2)) for r, h in enumerate(halves)], dim)
    assert not torch.equal(other, want)


def test_clip_without_a_model_axis_is_the_plain_norm():
    """At one model rank the flags change nothing: the same bits."""
    grads = [torch.randn(5), torch.randn(3, 2)]
    plain = [g.clone() for g in grads]
    n1 = clip_by_global_norm_(plain, 0.1)
    n2 = clip_by_global_norm_(grads, 0.1, [True, False])
    assert torch.equal(n1, n2) and all(torch.equal(a, b) for a, b in zip(plain, grads))


@pytest.mark.parametrize("world,want", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (6, (3, 2)),
                                        (8, (4, 2))])
def test_default_layout_is_the_jax_dryruns(world, want):
    """``default_mesh`` follows ``__graft_entry__``'s rule and lays out what
    ``make_mesh`` builds over ``world`` devices (rank d * n_model + m at
    (d, m), row-major)."""
    mesh = default_mesh(world)
    assert layout_shape(mesh, world) == want
    jmesh = make_mesh(JMesh(n_model=mesh.n_model), jax.devices()[:world])
    assert tuple(jmesh.devices.shape) == want
    ids = np.vectorize(lambda d: d.id)(jmesh.devices) - jax.devices()[0].id
    assert (ids == np.arange(world).reshape(want)).all()


def test_a_layout_that_does_not_fill_the_world_raises():
    with pytest.raises(ValueError, match="does not fill"):
        layout_shape(MeshConfig(n_data=3, n_model=2), 4)
    with pytest.raises(ValueError, match="does not fill"):
        layout_shape(MeshConfig(n_model=3), 4)
