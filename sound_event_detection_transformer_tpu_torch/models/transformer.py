"""DETR-style encoder-decoder transformer, batch-first.

Counterpart of the JAX package's ``models/transformer.py``: positional
embeddings are added to Q/K (not V) at every attention, layers are pre-norm
or post-norm, and the decoder returns the stack of all layers' normed
outputs.  Every LayerNorm uses eps 1e-6, flax's default.  Dropout falls
where the JAX package's does (the attention probabilities, the FFN hidden,
every residual branch) unless ``deterministic``; its masks come from the
``generator`` handed down with the inputs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import scaled_dot_attention
from ..ops.dropout import dropout

LN_EPS = 1e-6


def _linear(d_in: int, d_out: int) -> nn.Linear:
    lin = nn.Linear(d_in, d_out)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around :func:`scaled_dot_attention`."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.q_proj = _linear(d_model, d_model)
        self.k_proj = _linear(d_model, d_model)
        self.v_proj = _linear(d_model, d_model)
        self.out_proj = _linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        b, sq, d = q_in.shape
        sk = k_in.shape[1]
        hd = d // self.nhead
        q = self.q_proj(q_in).reshape(b, sq, self.nhead, hd).transpose(1, 2)
        k = self.k_proj(k_in).reshape(b, sk, self.nhead, hd).transpose(1, 2)
        v = self.v_proj(v_in).reshape(b, sk, self.nhead, hd).transpose(1, 2)
        if deterministic or self.dropout == 0.0:  # the eval and predict paths' call
            out = scaled_dot_attention(q, k, v, bias)
        else:
            out = scaled_dot_attention(q, k, v, bias, dropout_rate=self.dropout,
                                       generator=generator)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, d))


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear1 = _linear(d_model, dim_feedforward)
        self.linear2 = _linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.linear1(x)), self.dropout, generator, deterministic)
        return self.linear2(h)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.0,
                 pre_norm: bool = True):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ffn = FFN(d_model, dim_feedforward, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        drop = lambda x: dropout(x, self.dropout, generator, deterministic)
        kw = dict(deterministic=deterministic, generator=generator)
        if self.pre_norm:
            s2 = self.norm1(src)
            qk = s2 + pos
            src = src + drop(self.self_attn(qk, qk, s2, key_bias, **kw))
            return src + drop(self.ffn(self.norm2(src), **kw))
        qk = src + pos
        src = self.norm1(src + drop(self.self_attn(qk, qk, src, key_bias, **kw)))
        return self.norm2(src + drop(self.ffn(src, **kw)))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.0,
                 pre_norm: bool = True):
        super().__init__()
        self.pre_norm = pre_norm
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ffn = FFN(d_model, dim_feedforward, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, pos, mem_key_bias, self_attn_bias,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        drop = lambda x: dropout(x, self.dropout, generator, deterministic)
        kw = dict(deterministic=deterministic, generator=generator)
        if self.pre_norm:
            t2 = self.norm1(tgt)
            qk = t2 + query_pos
            tgt = tgt + drop(self.self_attn(qk, qk, t2, self_attn_bias, **kw))
            t2 = self.norm2(tgt)
            tgt = tgt + drop(
                self.cross_attn(t2 + query_pos, memory + pos, memory, mem_key_bias, **kw))
            return tgt + drop(self.ffn(self.norm3(tgt), **kw))
        qk = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt, self_attn_bias, **kw)))
        tgt = self.norm2(tgt + drop(
            self.cross_attn(tgt + query_pos, memory + pos, memory, mem_key_bias, **kw)))
        return self.norm3(tgt + drop(self.ffn(tgt, **kw)))


class Transformer(nn.Module):
    """Encoder-decoder over flattened [B, S, D] sequences.

    ``forward(src, pos, key_padding_bias, query, decoder_self_bias,
    deterministic, generator)`` returns (hs [L, B, Q, D], all decoder layers
    normed, and memory [B, S, D]).
    """

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 3,
                 num_decoder_layers: int = 3, dim_feedforward: int = 2048,
                 dropout: float = 0.1, pre_norm: bool = True):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}",
                            EncoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm))
        if pre_norm:  # encoder_norm exists only when normalizing before
            self.encoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}",
                            DecoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm))
        self.decoder_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, key_padding_bias, query, decoder_self_bias=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        kw = dict(deterministic=deterministic, generator=generator)
        out = src
        for i in range(self.num_encoder_layers):
            out = getattr(self, f"encoder_layer_{i}")(out, pos, key_padding_bias, **kw)
        if hasattr(self, "encoder_norm"):
            out = self.encoder_norm(out)
        memory = out

        tgt = torch.zeros_like(query)
        sa_bias = None if decoder_self_bias is None else decoder_self_bias[None, None]
        intermediate = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer_{i}")(
                tgt, memory, query, pos, key_padding_bias, sa_bias, **kw)
            intermediate.append(self.decoder_norm(tgt))
        return torch.stack(intermediate, dim=0), memory


def block_diagonal_bias(num_queries: int, num_groups: int,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Additive [Q, Q] f32 decoder self-attention mask: -1e9 off the
    per-group diagonal blocks."""
    group = torch.arange(num_queries, device=device) // (num_queries // num_groups)
    same = group[:, None] == group[None, :]
    return torch.where(same, 0.0, -1.0e9).float()
