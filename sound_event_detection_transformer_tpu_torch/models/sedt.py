"""SEDT model: backbone + transformer + set-prediction heads.

Counterpart of the JAX package's ``models/sedt.py``.  ``forward(feats
[B, T, F, 1], pad_mask [B, T], deterministic, generator)`` returns the JAX
package's output dict::

    {"pred_logits": [B, Q, C+1], "pred_boxes": [B, Q, 2],
     "at": [B, C] (dec_at), "at_p": [B, C] (pooling),
     "aux_logits": [A, B, Q, C+1], "aux_boxes": [A, B, Q, 2] (aux_loss)}

With ``compute_dtype`` bfloat16 the backbone and transformer run under bf16
autocast while parameters stay f32; the heads always run in f32.  Dropout is
decided by ``deterministic`` alone, never by ``module.training``: with
``deterministic=False`` the transformer drops at ``cfg.dropout`` with masks
drawn from ``generator``.

:class:`SPSEDT` is the self-supervised patch-query variant (SP-SEDT): its
``forward`` also takes the patch crops, and its queries come from them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import make_key_padding_bias
from .position_encoding import PositionEmbeddingLearned, sine_position_encoding
from .resnet import ResNetBackbone, num_backbone_channels
from .transformer import Transformer, _linear, block_diagonal_bias


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
    """Sound Event Detection Transformer."""

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
            dropout=cfg.dropout,
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

    def encode(self, feats: torch.Tensor, pad_mask: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               query_override: Optional[torch.Tensor] = None,
               decoder_self_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Backbone -> flatten -> transformer; returns hs [L, B, Q, D] in f32.

        ``query_override`` ([B, Q, D]) replaces the learned queries and
        ``decoder_self_bias`` ([Q, Q], additive) masks the decoder's
        self-attention (SP-SEDT's per-patch blocks)."""
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
        queries = (self.query_embed.weight[None].expand(b, -1, -1) if query_override is None
                   else query_override)
        with self._autocast(feats.device):
            hs, _ = self.transformer(src, pos, key_bias, queries, decoder_self_bias,
                                     deterministic=deterministic, generator=generator)
        return hs.float()

    def forward(self, feats: torch.Tensor, pad_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        hs = self.encode(feats, pad_mask, deterministic, generator)
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


class SPSEDT(SEDT):
    """Self-supervised patch-query SEDT.

    ``forward(feats, pad_mask, patches [B, P, ph, pw, 1], deterministic,
    generator)`` adds to :class:`SEDT` a second backbone pass over the
    patches, average-pooled and projected to the queries by ``patch2query``
    (``num_queries // num_patches`` queries a patch), a block-diagonal
    decoder self-attention bias (one block a patch), and with
    ``feature_recon`` the reconstruction head ``feature_align`` and the
    outputs ``pred_feature`` [B, Q, C], ``gt_feature`` [B, P, C] (the pooled
    patch features, with their gradient) and ``aux_feature`` [A, B, Q, C].

    Training (``deterministic=False``) draws from ``generator``: with
    ``query_shuffle`` one permutation of the event queries, then one keep
    mask [B, Q, 1] against ``mask_ratio``; the queries are
    ``2 * query_embed + patch_query * keep``, the doubling as in the JAX
    package.  Deterministically the query count follows the patch count
    (``P * per_patch``) and the queries are ``patch_query + query_embed``.
    ``patch2query`` and ``feature_align`` run in f32 on the pooled features,
    outside autocast, as the JAX package gives them no compute dtype; the
    pooled features keep the backbone's dtype.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        if cfg.num_queries % cfg.num_patches:
            raise ValueError(f"num_queries {cfg.num_queries} is not a multiple of "
                             f"num_patches {cfg.num_patches}")
        channels = num_backbone_channels(cfg.backbone)
        self.patch2query = _linear(channels, cfg.hidden_dim)
        if cfg.feature_recon:
            self.feature_align = MLP(cfg.hidden_dim, cfg.hidden_dim, channels, 2)

    def forward(self, feats: torch.Tensor, pad_mask: torch.Tensor, patches: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        dev = feats.device
        b, p = patches.shape[:2]
        per_patch = cfg.num_queries // cfg.num_patches
        with self._autocast(dev):
            pfeat = self.backbone(patches.flatten(0, 1))  # [B * P, T', F', C]
        patches_gt = pfeat.mean(dim=(1, 2))  # the average pool
        pq = self.patch2query(patches_gt.float())  # [B * P, D]
        pq = pq.reshape(b, p, 1, -1).expand(-1, -1, per_patch, -1).reshape(b, p * per_patch, -1)

        base_q = self.query_embed.weight[1:] if cfg.dec_at else self.query_embed.weight
        if not deterministic:
            if generator is None:
                raise ValueError("SPSEDT needs a generator when deterministic is False")
            if cfg.query_shuffle:  # one permutation of the event queries a step
                base_q = base_q[torch.randperm(cfg.num_queries, generator=generator,
                                               device=dev)]
            keep = torch.rand((b, cfg.num_queries, 1), generator=generator,
                              device=dev) > cfg.mask_ratio
            queries = 2.0 * base_q[None] + pq * keep.to(pq.dtype)
            nq = cfg.num_queries
        else:
            nq = p * per_patch  # the query count follows the patch count
            queries = pq + base_q[None, :nq]
        bias = block_diagonal_bias(cfg.num_queries, cfg.num_patches, device=dev)[:nq, :nq]
        hs = self.encode(feats, pad_mask, deterministic, generator, query_override=queries,
                         decoder_self_bias=bias)
        logits = self.class_embed(hs)  # [L, B, Q, C+1]
        boxes = torch.sigmoid(self.bbox_embed(hs))
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if cfg.feature_recon:
            feat_out = self.feature_align(hs)  # [L, B, Q, C_backbone]
            out["pred_feature"] = feat_out[-1]
            out["gt_feature"] = patches_gt.reshape(b, p, -1)
            if cfg.aux_loss:
                out["aux_feature"] = feat_out[:-1]
        if cfg.aux_loss:
            out["aux_logits"] = logits[:-1]
            out["aux_boxes"] = boxes[:-1]
        return out
