"""The parameters of SEDT and SP-SEDT by name and shape, and seeded weights.

The names are the ones the port's modules carry (``backbone.layer2_0.conv1.weight``),
so the benchmark can load one set of weights into the port by name (strictly:
a parameter or buffer the spec lacks, or one of another shape, fails the
load) and hand the same tensors to the reference.  The architecture is the
published one: a torchvision ResNet-50 with frozen batch norm and a dilated
last stage (DC5) behind a 1x1 lift from one to three channels, a pre-norm
DETR transformer, the class and box heads, SEDT's audio-tag query and
SP-SEDT's patch-query and reconstruction heads.

Weights are drawn on the device from one seed in a single call of
``torch.rand`` and mapped to each tensor's range: PyTorch's default range
for convolutions (bound 1 / sqrt(fan_in)), Xavier's for linear layers,
unit-variance embeddings, LayerNorm and FrozenBN near identity.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

STAGES = (3, 4, 6, 3)  # ResNet-50 blocks per stage
PLANES = (64, 128, 256, 512)
BACKBONE_CHANNELS = 2048


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    lo: float  # drawn uniformly from [lo, hi)
    hi: float
    buffer: bool = False  # a FrozenBN statistic, not a parameter


def _conv(name: str, cout: int, cin: int, k: int, bias: bool = False) -> List[Leaf]:
    b = 1.0 / math.sqrt(cin * k * k)
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), -b, b)]
    if bias:
        out.append(Leaf(f"{name}.bias", (cout,), -b, b))
    return out


def _bn(name: str, c: int) -> List[Leaf]:
    return [Leaf(f"{name}.scale", (c,), 0.8, 1.2, True), Leaf(f"{name}.bias", (c,), -0.1, 0.1, True),
            Leaf(f"{name}.mean", (c,), -0.1, 0.1, True), Leaf(f"{name}.var", (c,), 0.8, 1.2, True)]


def _linear(name: str, dout: int, din: int) -> List[Leaf]:
    b = math.sqrt(6.0 / (din + dout))
    return [Leaf(f"{name}.weight", (dout, din), -b, b),
            Leaf(f"{name}.bias", (dout,), -0.02, 0.02)]


def _norm(name: str, d: int) -> List[Leaf]:
    return [Leaf(f"{name}.weight", (d,), 0.9, 1.1), Leaf(f"{name}.bias", (d,), -0.1, 0.1)]


def backbone_spec() -> List[Leaf]:
    out = _conv("backbone.conv0", 3, 1, 1, bias=True) + _conv("backbone.conv1", 64, 3, 7)
    out += _bn("backbone.bn1", 64)
    cin = 64
    for li, (n, p) in enumerate(zip(STAGES, PLANES)):
        for bi in range(n):
            pre = f"backbone.layer{li + 1}_{bi}"
            out += _conv(f"{pre}.conv1", p, cin, 1) + _bn(f"{pre}.bn1", p)
            out += _conv(f"{pre}.conv2", p, p, 3) + _bn(f"{pre}.bn2", p)
            out += _conv(f"{pre}.conv3", 4 * p, p, 1) + _bn(f"{pre}.bn3", 4 * p)
            if bi == 0:
                out += _conv(f"{pre}.downsample_conv", 4 * p, cin, 1)
                out += _bn(f"{pre}.downsample_bn", 4 * p)
            cin = 4 * p
    return out


def _attention(name: str, d: int) -> List[Leaf]:
    return [leaf for p in ("q_proj", "k_proj", "v_proj", "out_proj")
            for leaf in _linear(f"{name}.{p}", d, d)]


def param_spec(m: Dict) -> List[Leaf]:
    """Every parameter and FrozenBN buffer of the model that ``m`` (the
    reference's model settings, :func:`.model.model_settings`) describes."""
    d, ff = m["hidden_dim"], m["dim_feedforward"]
    out = backbone_spec()
    for i in range(m["enc_layers"]):
        pre = f"transformer.encoder_layer_{i}"
        out += _attention(f"{pre}.self_attn", d)
        out += _linear(f"{pre}.ffn.linear1", ff, d) + _linear(f"{pre}.ffn.linear2", d, ff)
        out += _norm(f"{pre}.norm1", d) + _norm(f"{pre}.norm2", d)
    out += _norm("transformer.encoder_norm", d)
    for i in range(m["dec_layers"]):
        pre = f"transformer.decoder_layer_{i}"
        out += _attention(f"{pre}.self_attn", d) + _attention(f"{pre}.cross_attn", d)
        out += _linear(f"{pre}.ffn.linear1", ff, d) + _linear(f"{pre}.ffn.linear2", d, ff)
        out += _norm(f"{pre}.norm1", d) + _norm(f"{pre}.norm2", d) + _norm(f"{pre}.norm3", d)
    out += _norm("transformer.decoder_norm", d)
    n_queries = m["num_queries"] + (1 if m["dec_at"] else 0)
    s3 = math.sqrt(3.0)
    out.append(Leaf("query_embed.weight", (n_queries, d), -s3, s3))
    out += _conv("input_proj", d, BACKBONE_CHANNELS, 1, bias=True)
    out += _linear("class_embed", m["num_classes"] + 1, d)
    out += _linear("bbox_embed.layer0", d, d) + _linear("bbox_embed.layer1", d, d)
    out += _linear("bbox_embed.layer2", 2, d)
    if m["dec_at"]:
        out += _linear("weak_class_embed", m["num_classes"], d)
    if m["self_sup"]:
        out += _linear("patch2query", d, BACKBONE_CHANNELS)
        if m["feature_recon"]:
            out += _linear("feature_align.layer0", d, d)
            out += _linear("feature_align.layer1", BACKBONE_CHANNELS, d)
    return out


def make_weights(spec: List[Leaf], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One f32 tensor per leaf on ``device``, from one draw of ``seed``:
    the same seed on the same device gives the same bits."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(leaf.shape) for leaf in spec]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for leaf, u in zip(spec, torch.split(flat, sizes)):
        out[leaf.name] = (leaf.lo + (leaf.hi - leaf.lo) * u).reshape(leaf.shape)
    return out
