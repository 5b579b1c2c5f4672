"""Scaled dot-product attention with additive f32 mask biases.

Counterpart of the JAX package's ``ops/attention.py``.  Masks are additive
biases (0 = keep, -1e9 = drop) and the softmax runs in f32 whatever the
compute dtype.  Long keys dispatch to the flash kernel K4, which is not
ported yet: that case raises instead of running the plain path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-head attention core; returns [B, H, Sq, D] in v's dtype."""
    if use_flash is None:
        use_flash = k.shape[-2] >= FLASH_MIN_SEQ and dropout_rate == 0.0 and k.is_cuda
    if use_flash:
        raise NotImplementedError(
            "flash attention (kernel K4, _flash_kernel) is not ported yet; "
            f"Sk = {k.shape[-2]} >= FLASH_MIN_SEQ = {FLASH_MIN_SEQ} selects it"
        )
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout lands with the training slice")
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
