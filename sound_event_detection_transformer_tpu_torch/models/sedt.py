"""SEDT model: backbone + transformer + set-prediction heads.

Counterpart of the JAX package's ``models/sedt.py``.  ``forward(feats
[B, T, F, 1], pad_mask [B, T])`` returns the JAX package's output dict::

    {"pred_logits": [B, Q, C+1], "pred_boxes": [B, Q, 2],
     "at": [B, C] (dec_at), "at_p": [B, C] (pooling),
     "aux_logits": [A, B, Q, C+1], "aux_boxes": [A, B, Q, 2] (aux_loss)}

With ``compute_dtype`` bfloat16 the backbone and transformer run under bf16
autocast while parameters stay f32; the heads always run in f32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import make_key_padding_bias
from .position_encoding import PositionEmbeddingLearned, sine_position_encoding
from .resnet import ResNetBackbone, num_backbone_channels
from .transformer import Transformer, _linear


class MLP(nn.Module):
    """num_layers-deep ReLU MLP; layers named layer0 .. layer{n-1}."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", _linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


def downsample_mask(pad_mask: torch.Tensor, t_out: int, f_out: int) -> torch.Tensor:
    """[B, T] frame padding mask -> [B, T', F'] on the backbone's output grid.

    Nearest-neighbour with half-pixel centres, as ``jax.image.resize``:
    source frame floor((i + 0.5) * T / T'), computed in f32.
    """
    b, t = pad_mask.shape
    src = ((torch.arange(t_out, dtype=torch.float32, device=pad_mask.device) + 0.5)
           * t / t_out).floor().long()
    return pad_mask[:, src][:, :, None].expand(b, t_out, f_out)


class SEDT(nn.Module):
    """Sound Event Detection Transformer (evaluation forward)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetBackbone(cfg.backbone, cfg.dilation)
        self.transformer = Transformer(
            d_model=cfg.hidden_dim,
            nhead=cfg.nheads,
            num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            pre_norm=cfg.pre_norm,
        )
        n_queries = cfg.num_queries + 1 if cfg.dec_at else cfg.num_queries
        self.query_embed = nn.Embedding(n_queries, cfg.hidden_dim)
        self.input_proj = nn.Conv2d(num_backbone_channels(cfg.backbone), cfg.hidden_dim, 1)
        self.class_embed = _linear(cfg.hidden_dim, cfg.num_classes + 1)
        self.bbox_embed = MLP(cfg.hidden_dim, cfg.hidden_dim, 2, 3)
        if cfg.dec_at:
            self.weak_class_embed = _linear(cfg.hidden_dim, cfg.num_classes)
        if cfg.pooling is not None and "attn" in cfg.pooling:
            self.attn_dense_softmax = nn.Linear(cfg.hidden_dim, cfg.num_classes)
        if cfg.position_embedding == "learned":
            self.pos_embed_learned = PositionEmbeddingLearned(cfg.hidden_dim)

    def _autocast(self, device: torch.device):
        if self.cfg.compute_dtype == "float32":
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=getattr(torch, self.cfg.compute_dtype))

    def encode(self, feats: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """Backbone -> flatten -> transformer; returns hs [L, B, Q, D] in f32."""
        cfg = self.cfg
        with self._autocast(feats.device):
            x = self.backbone(feats)  # [B, T', F', C]
        b, tp, fp, _ = x.shape
        mask3 = downsample_mask(pad_mask, tp, fp)
        if cfg.position_embedding == "learned":
            pos = self.pos_embed_learned(mask3)
        else:
            pos = sine_position_encoding(mask3, cfg.hidden_dim)
        # input_proj runs in f32 (the JAX package gives it no compute dtype),
        # so the transformer's residual stream starts in f32
        src = self.input_proj(x.permute(0, 3, 1, 2).float())  # [B, D, T', F']
        src = src.flatten(2).transpose(1, 2)  # [B, T'F', D], time-major
        pos = pos.reshape(b, tp * fp, cfg.hidden_dim)
        key_bias = make_key_padding_bias(mask3.reshape(b, tp * fp))
        queries = self.query_embed.weight[None].expand(b, -1, -1)
        with self._autocast(feats.device):
            hs, _ = self.transformer(src, pos, key_bias, queries)
        return hs.float()

    def forward(self, feats: torch.Tensor, pad_mask: torch.Tensor):
        cfg = self.cfg
        hs = self.encode(feats, pad_mask)
        out = {}
        if cfg.dec_at:
            hs_events = hs[:, :, 1:, :]  # slot 0 is the audio-tag query
            out["at"] = torch.sigmoid(self.weak_class_embed(hs[-1, :, 0, :]))
        else:
            hs_events = hs
        logits = self.class_embed(hs_events)  # [L, B, Q, C+1]
        boxes = torch.sigmoid(self.bbox_embed(hs_events))  # [L, B, Q, 2]
        out["pred_logits"] = logits[-1]
        out["pred_boxes"] = boxes[-1]
        if cfg.pooling is not None:
            out["at_p"] = self._pool(hs_events[-1], logits[-1], boxes[-1])
        if cfg.aux_loss:
            out["aux_logits"] = logits[:-1]
            out["aux_boxes"] = boxes[:-1]
        return out

    def _pool(self, hs_last, logits, boxes):
        """Query-pooling audio-tag branch."""
        pooling = self.cfg.pooling
        class_pro = torch.softmax(logits, dim=-1)[..., :-1]  # [B, Q, C]
        if "weighted_sum" in pooling:
            return (class_pro * boxes[:, :, 1:2]).sum(1).clamp(0.0, 1.0)
        if "attn" in pooling:
            sof = torch.softmax(self.attn_dense_softmax(hs_last), dim=-1).clamp(1e-7, 1.0)
            return (sof * class_pro).sum(1) / sof.sum(1)
        if "max" in pooling:
            return class_pro.max(1).values
        return class_pro.mean(1)  # 'avg'
