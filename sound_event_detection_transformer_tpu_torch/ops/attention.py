"""Scaled dot-product attention with additive f32 mask biases.

Counterpart of the JAX package's ``ops/attention.py``.  Masks are additive
biases (0 = keep, -1e9 = drop) and the softmax runs in f32 whatever the
compute dtype.  Long keys on the GPU dispatch to the flash kernel K4
(:mod:`.flash_attention`); everything else, and any attention with dropout,
takes the plain path, where dropout falls on the f32 probabilities before
they are cast to v's type.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from .dropout import dropout
from .flash_attention import flash_attention, reference_attention

NEG_INF_BIAS = -1.0e9
FLASH_MIN_SEQ = 512


def make_key_padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """[B, Sk] bool (True = padded) -> additive f32 bias [B, 1, 1, Sk]."""
    bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                       device=key_padding_mask.device)
    return bias.masked_fill(key_padding_mask, NEG_INF_BIAS)[:, None, None, :]


def scaled_dot_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-head attention core; returns [B, H, Sq, D] in v's dtype.

    ``use_flash=None`` picks kernel K4 for ``Sk >= FLASH_MIN_SEQ`` without
    dropout on CUDA tensors.  ``use_flash=True`` on CPU tensors runs the
    kernel's plain blockwise version.  ``dropout_rate > 0`` drops
    probabilities with masks drawn from ``generator``.
    """
    if use_flash is None:
        use_flash = k.shape[-2] >= FLASH_MIN_SEQ and dropout_rate == 0.0 and k.is_cuda
    if use_flash:
        return flash_attention(q, k, v, bias)
    if dropout_rate == 0.0:
        return reference_attention(q, k, v, bias)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        logits = logits + bias
    probs = dropout(torch.softmax(logits, dim=-1), dropout_rate, generator, False)
    return torch.matmul(probs.to(v.dtype), v)
