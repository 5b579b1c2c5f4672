"""AST, the Audio Spectrogram Transformer (Gong, Chung and Glass, Interspeech
2021, arXiv:2104.01778): a DeiT-B over overlapping log-mel patches, the
audio-tag trainer's transformer model.

Published AudioSet settings (:data:`AUDIOSET`): input ``[B, T=1024, F=128]``;
a 16 x 16 patch convolution at strides (10, 10) over ``[B, 1, F, T]`` gives a
12 x 101 grid, flattened frequency-major to 1,212 tokens; the class and
distillation tokens go in front (N = 1,214) and a learned position
embedding is added; 12 pre-norm blocks of d 768, 12 heads of 64 and an MLP of
3,072 (GELU, erf form), LayerNorm eps 1e-6, no dropout; the final norm, the
mean of the two leading tokens, then ``LayerNorm -> Linear`` to the 527
classes' logits.

Parameter names follow the upstream model (``v.patch_embed.proj``,
``v.cls_token``, ``v.dist_token``, ``v.pos_embed``,
``v.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``v.norm``,
``mlp_head.{0,1}``), so a published state dict loads with
``load_state_dict``.  Every attention goes through
:func:`..ops.attention.scaled_dot_attention` with no bias and no dropout:
kernel K4 on the card at the published 1,214 keys, the plain path on the
CPU.  The inputs are normalised by the data, as the recipe's loader does:
``(fbank + 4.2677393) / (2 * 4.5689974)``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import scaled_dot_attention


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    """AST's geometry and widths; the defaults are the published AudioSet
    model."""

    n_mels: int = 128
    frames: int = 1024
    patch: int = 16
    fstride: int = 10
    tstride: int = 10
    num_classes: int = 527
    dim: int = 768
    heads: int = 12
    layers: int = 12
    mlp: int = 3072
    eps: float = 1e-6

    @property
    def grid(self) -> tuple:
        """(frequency, time) patch counts."""
        return ((self.n_mels - self.patch) // self.fstride + 1,
                (self.frames - self.patch) // self.tstride + 1)

    @property
    def tokens(self) -> int:
        """Patches plus the class and distillation tokens."""
        f, t = self.grid
        return f * t + 2


AUDIOSET = ASTConfig()


class PatchEmbed(nn.Module):
    def __init__(self, c: ASTConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, c.dim, c.patch, stride=(c.fstride, c.tstride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, F, T] -> [B, F' T', d], frequency the outer index."""
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, c: ASTConfig):
        super().__init__()
        self.heads = c.heads
        self.qkv = nn.Linear(c.dim, 3 * c.dim)
        self.proj = nn.Linear(c.dim, c.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        # q, k and v are strided views of the one product (K4 reads strides)
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        out = scaled_dot_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, c: ASTConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.dim, c.mlp)
        self.fc2 = nn.Linear(c.mlp, c.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, c: ASTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(c.dim, eps=c.eps)
        self.attn = Attention(c)
        self.norm2 = nn.LayerNorm(c.dim, eps=c.eps)
        self.mlp = Mlp(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DistilledViT(nn.Module):
    """The DeiT body: patches, the two leading tokens, positions, blocks and
    the final norm."""

    def __init__(self, c: ASTConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.tokens, c.dim))
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.layers))
        self.norm = nn.LayerNorm(c.dim, eps=c.eps)


class AST(nn.Module):
    """[B, T, F] or [B, T, F, 1] log-mel -> [B, num_classes] logits."""

    def __init__(self, c: ASTConfig = AUDIOSET):
        super().__init__()
        self.config = c
        self.v = DistilledViT(c)
        self.mlp_head = nn.Sequential(nn.LayerNorm(c.dim), nn.Linear(c.dim, c.num_classes))
        self._init_weights()

    def _init_weights(self) -> None:
        """DeiT's: truncated normal (std 0.02) for the tokens, positions and
        the blocks' linear weights, zero biases; the patch convolution and
        the head keep PyTorch's defaults."""
        v = self.v
        for p in (v.cls_token, v.dist_token, v.pos_embed):
            nn.init.trunc_normal_(p, std=0.02)
        for m in v.blocks.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:  # the trainer's [B, T, F, 1]
            x = x[..., 0]
        v = self.v
        x = v.patch_embed(x.unsqueeze(1).transpose(2, 3))
        b = x.shape[0]
        x = torch.cat([v.cls_token.expand(b, -1, -1), v.dist_token.expand(b, -1, -1), x], dim=1)
        x = x + v.pos_embed
        for blk in v.blocks:
            x = blk(x)
        x = v.norm(x)
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)
