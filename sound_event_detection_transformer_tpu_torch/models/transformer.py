"""DETR-style encoder-decoder transformer, batch-first.

Counterpart of the JAX package's ``models/transformer.py``: positional
embeddings are added to Q/K (not V) at every attention, layers are pre-norm
or post-norm, and the decoder returns the stack of all layers' normed
outputs.  Every LayerNorm uses eps 1e-6, flax's default.  This slice is the
evaluation path, so dropout is the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import scaled_dot_attention

LN_EPS = 1e-6


def _linear(d_in: int, d_out: int) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around :func:`scaled_dot_attention`."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = _linear(d_model, d_model)
        self.k_proj = _linear(d_model, d_model)
        self.v_proj = _linear(d_model, d_model)
        self.out_proj = _linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, bias: Optional[torch.Tensor] = None):
        b, sq, d = q_in.shape
        sk = k_in.shape[1]
        hd = d // self.nhead
        q = self.q_proj(q_in).reshape(b, sq, self.nhead, hd).transpose(1, 2)
        k = self.k_proj(k_in).reshape(b, sk, self.nhead, hd).transpose(1, 2)
        v = self.v_proj(v_in).reshape(b, sk, self.nhead, hd).transpose(1, 2)
        out = scaled_dot_attention(q, k, v, bias)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, d))


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = _linear(d_model, dim_feedforward)
        self.linear2 = _linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, pre_norm: bool = True):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FFN(d_model, dim_feedforward)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_bias):
        if self.pre_norm:
            s2 = self.norm1(src)
            qk = s2 + pos
            src = src + self.self_attn(qk, qk, s2, key_bias)
            return src + self.ffn(self.norm2(src))
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src, key_bias))
        return self.norm2(src + self.ffn(src))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, pre_norm: bool = True):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FFN(d_model, dim_feedforward)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, pos, mem_key_bias, self_attn_bias):
        if self.pre_norm:
            t2 = self.norm1(tgt)
            qk = t2 + query_pos
            tgt = tgt + self.self_attn(qk, qk, t2, self_attn_bias)
            t2 = self.norm2(tgt)
            tgt = tgt + self.cross_attn(t2 + query_pos, memory + pos, memory, mem_key_bias)
            return tgt + self.ffn(self.norm3(tgt))
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt, self_attn_bias))
        tgt = self.norm2(
            tgt + self.cross_attn(tgt + query_pos, memory + pos, memory, mem_key_bias))
        return self.norm3(tgt + self.ffn(tgt))


class Transformer(nn.Module):
    """Encoder-decoder over flattened [B, S, D] sequences.

    ``forward(src, pos, key_padding_bias, query, decoder_self_bias)`` returns
    (hs [L, B, Q, D], all decoder layers normed, and memory [B, S, D]).
    """

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 3, dim_feedforward: int = 2048,
                 pre_norm: bool = True):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}",
                            EncoderLayer(d_model, nhead, dim_feedforward, pre_norm))
        if pre_norm:  # encoder_norm exists only when normalizing before
            self.encoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}",
                            DecoderLayer(d_model, nhead, dim_feedforward, pre_norm))
        self.decoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_padding_bias, query, decoder_self_bias=None):
        out = src
        for i in range(self.num_encoder_layers):
            out = getattr(self, f"encoder_layer_{i}")(out, pos, key_padding_bias)
        if hasattr(self, "encoder_norm"):
            out = self.encoder_norm(out)
        memory = out

        tgt = torch.zeros_like(query)
        sa_bias = None if decoder_self_bias is None else decoder_self_bias[None, None]
        intermediate = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer_{i}")(
                tgt, memory, query, pos, key_padding_bias, sa_bias)
            intermediate.append(self.decoder_norm(tgt))
        return torch.stack(intermediate, dim=0), memory


def block_diagonal_bias(num_queries: int, num_groups: int,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Additive [Q, Q] f32 decoder self-attention mask: -1e9 off the
    per-group diagonal blocks."""
    group = torch.arange(num_queries, device=device) // (num_queries // num_groups)
    same = group[:, None] == group[None, :]
    return torch.where(same, 0.0, -1.0e9).float()
