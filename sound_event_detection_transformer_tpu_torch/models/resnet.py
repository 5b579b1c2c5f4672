"""ResNet backbones with frozen batch norm, and the audio-tag model on one.

Counterpart of the JAX package's ``models/resnet.py``.  The public layout is
the JAX package's, input [B, T, F, 1] and output [B, T', F', C]; inside, the
trunk runs NCHW.  Module and parameter names follow the flax tree
(``conv0``, ``conv1``, ``bn1``, ``layer{stage}_{block}``, ``downsample_conv``;
``backbone``, ``fc1``, ``fc2`` in :class:`AudioTagBackbone`) so that
:func:`..weights.from_flax` maps one onto the other by name.

Every FrozenBN follows a convolution, and the blocks fold it in
(:func:`conv_bn`): ``bn(conv(x, W))`` is ``conv(x, W * w) + b``, one
convolution with a bias in place of a convolution and two passes over its
output.  ``(w, b)`` and, where no gradient can reach ``W``, the folded weight
are built once per state of their sources and kept (:class:`FrozenBatchNorm`);
:data:`FOLDS` counts how often each was reused and rebuilt.
"""
from __future__ import annotations

import collections
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5

# reuses and rebuilds of the cached folds since the process began: ``wb_*``
# of every FrozenBN's (w, b), ``weight_*`` of a frozen convolution's W * w
FOLDS: collections.Counter = collections.Counter()


def fold_summary(since: collections.Counter) -> str:
    """The share of folds reused since the snapshot ``since`` (a copy of
    :data:`FOLDS`), for (w, b) and for the frozen convolutions' weights."""
    parts = []
    for kind, label in (("wb", "(w, b)"), ("weight", "frozen W'")):
        reused = FOLDS[f"{kind}_reused"] - since[f"{kind}_reused"]
        total = reused + FOLDS[f"{kind}_rebuilt"] - since[f"{kind}_rebuilt"]
        share = f"{100.0 * reused / total:.1f} %" if total else "-"
        parts.append(f"{label} {share} of {total}")
    return "fold reuse: " + ", ".join(parts)


def _key(*tensors: torch.Tensor) -> Tuple:
    """What identifies the values of ``tensors``: where each lives and how
    often it was written in place."""
    return tuple((t.device, t.dtype, t.data_ptr(), t._version) for t in tensors)


class _Fold:
    """A FrozenBN's cached folds, made outside autograd and as normal tensors
    even under ``torch.inference_mode`` (the evaluation step), so a training
    pass can use them next.  The sources' detached views are kept with them,
    so that no other tensor takes a source's memory (and its ``data_ptr``)
    while the entry lives.  A deep copy starts empty and rebuilds from its
    own buffers."""

    def __init__(self):
        self.key = self.w = self.b = None
        self.sources: Tuple = ()
        self.drop_weight()

    def drop_weight(self) -> None:
        self.weight_key = self.weight = self.weight_source = None

    def __deepcopy__(self, memo) -> "_Fold":
        return _Fold()


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, held as buffers
    and folded into one multiply-add: w = scale / sqrt(var + eps),
    b = bias - mean * w.  ``(w, b)`` are built once per state of the buffers
    (a load, a move or an in-place write rebuilds them) and kept as plain
    attributes, out of the state dict."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self._fold = _Fold()

    def affine(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(w, b)``: the scale in the buffers' f32, the shift in ``dtype``
        (what the convolution consumes)."""
        f = self._fold
        bufs = (self.scale, self.bias, self.mean, self.var)
        key = (dtype,) + _key(*bufs)
        if f.key == key:
            FOLDS["wb_reused"] += 1
            return f.w, f.b
        with torch.inference_mode(False), torch.no_grad():
            w = self.scale * torch.reciprocal(torch.sqrt(self.var + BN_EPS))
            f.w, f.b = w, (self.bias - self.mean * w).to(dtype)
        f.key, f.sources = key, tuple(t.detach() for t in bufs)
        f.drop_weight()
        FOLDS["wb_rebuilt"] += 1
        return f.w, f.b

    def folded_weight(self, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``weight * w`` per output channel, formed in f32 and kept in
        ``dtype``, for a convolution that no gradient reaches; call after
        :meth:`affine`, which drops it when the buffers change."""
        f = self._fold
        key = (dtype,) + _key(weight)
        if f.weight_key == key:
            FOLDS["weight_reused"] += 1
            return f.weight
        with torch.inference_mode(False), torch.no_grad():
            f.weight = (weight * f.w[:, None, None, None]).to(dtype)
        f.weight_key, f.weight_source = key, weight.detach()
        FOLDS["weight_rebuilt"] += 1
        return f.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [B, C, H, W]
        w, b = self.affine(x.dtype)
        return x * w.to(x.dtype)[:, None, None] + b[:, None, None]


def conv_bn(conv: nn.Conv2d, bn: FrozenBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn(conv(x))`` as one convolution, ``conv(x, W * w) + b``, for a
    ``conv`` without bias.  Where ``W`` trains under grad mode, ``W * w`` is
    formed on every call in f32 (autocast casts it as it would cast ``W``),
    so that autograd gives ``W`` its gradient; elsewhere (a frozen ``W``,
    ``no_grad``, an EMA teacher) it is cached in the compute dtype."""
    dev = x.device.type  # the convolution computes in autocast's dtype, when it is on
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    w, b = bn.affine(dtype)
    weight = conv.weight
    if torch.is_grad_enabled() and weight.requires_grad:
        bn._fold.drop_weight()  # an evaluation's copy, stale from the next update
        weight = weight * w[:, None, None, None]
    else:
        weight = bn.folded_weight(weight, dtype)
    return F.conv2d(x, weight, b, conv.stride, conv.padding, conv.dilation, conv.groups)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
          bias: bool = False) -> nn.Conv2d:
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride, dilation) -> 1x1(x4)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        self.has_downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = F.relu(conv_bn(self.conv2, self.bn2, out))
        out = conv_bn(self.conv3, self.bn3, out)
        sc = conv_bn(self.downsample_conv, self.downsample_bn, x) if self.has_downsample else x
        return F.relu(out + sc)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet18/34): 3x3 -> 3x3."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, dilation)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = _conv(cin, planes, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes)
        self.has_downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = conv_bn(self.conv2, self.bn2, out)
        sc = conv_bn(self.downsample_conv, self.downsample_bn, x) if self.has_downsample else x
        return F.relu(out + sc)


_ARCHS = {
    # name: (block, blocks_per_stage)
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


def num_backbone_channels(name: str) -> int:
    return 512 * _ARCHS[name][0].expansion


class ResNetBackbone(nn.Module):
    """conv0 + torch-layout ResNet trunk, tapping layer4.

    [B, T, F, 1] -> [B, T', F', num_channels], stride 16 with ``dilation``
    (DC5) and 32 without.  The stem is conv1 (7x7/2) applied to the output of
    conv0 (a 1x1 lift from 1 to 3 channels, with bias); conv1 zero-pads that
    output, which is what the JAX package's composed stem computes.
    """

    def __init__(self, arch: str = "resnet50", dilation: bool = True):
        super().__init__()
        block, stages = _ARCHS[arch]
        self.conv0 = nn.Conv2d(1, 3, 1, bias=True)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        planes = (64, 128, 256, 512)
        strides = (1, 2, 2, 1 if dilation else 2)
        dilations = (1, 1, 1, 2 if dilation else 1)
        self.block_names = []
        cin = 64
        for li, (n_blocks, p, s, d) in enumerate(zip(stages, planes, strides, dilations)):
            for bi in range(n_blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, block(
                    cin, p,
                    stride=s if bi == 0 else 1,
                    # the first block of a dilated stage keeps dilation 1
                    dilation=1 if (bi == 0 and d > 1) else d,
                    downsample=(bi == 0 and (s != 1 or li > 0 or block is Bottleneck)),
                ))
                self.block_names.append(name)
                cin = p * block.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # [B, 1, T, F]
        x = F.relu(conv_bn(self.conv1, self.bn1, self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1)  # [B, T', F', C]


def _dense(d_in: int, d_out: int) -> nn.Linear:
    """A linear layer with flax ``nn.Dense``'s init: LeCun normal (truncated
    at two standard deviations) weights, zero bias."""
    lin = nn.Linear(d_in, d_out)
    std = math.sqrt(1.0 / d_in) / 0.87962566103423978  # truncation's variance loss undone
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(lin.bias)
    return lin


class AudioTagBackbone(nn.Module):
    """Clip tagging: ResNet -> global pool over (T', F') -> fc1 (2048 -> 1000)
    -> ReLU -> fc2 (1000 -> C).

    [B, T, F, 1] -> [B, C]: the logits with ``logits_out``, else their
    sigmoid.  ``pooling`` is ``"max"`` or ``"avg"``.  Its ``backbone``
    initialises SP-SEDT's (``utils.checkpoint.load_audio_tag_backbone``).
    The trainer takes the logits, for a logit-space BCE: a probability-space
    BCE has no gradient where a cold backbone saturates the sigmoid.
    """

    def __init__(self, arch: str = "resnet50", dilation: bool = True, pooling: str = "max",
                 num_classes: int = 10, logits_out: bool = False):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"pooling must be 'max' or 'avg', not {pooling!r}")
        self.backbone = ResNetBackbone(arch, dilation)
        self.fc1 = _dense(num_backbone_channels(arch), 1000)
        self.fc2 = _dense(1000, num_classes)
        self.pooling = pooling
        self.logits_out = logits_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)  # [B, T', F', C]
        pooled = feats.amax(dim=(1, 2)) if self.pooling == "max" else feats.mean(dim=(1, 2))
        logits = self.fc2(F.relu(self.fc1(pooled)))
        return logits if self.logits_out else torch.sigmoid(logits)
