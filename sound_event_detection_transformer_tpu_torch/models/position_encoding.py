"""Time-axis positional encodings (sine over normalized unmasked-frame
counts, or a learned table), as in the JAX package."""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def sine_position_encoding(
    pad_mask: torch.Tensor,  # [B, T', F'] bool, True = padded
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """Returns [B, T', F', num_pos_feats] f32."""
    not_mask = (~pad_mask).float()
    y = torch.cumsum(not_mask, dim=1)  # over time
    if normalize:
        y = y / (y[:, -1:, :] + 1e-6) * scale
    i = torch.arange(num_pos_feats, device=pad_mask.device)
    dim_t = temperature ** (2.0 * torch.div(i, 2, rounding_mode="floor").float() / num_pos_feats)
    pos = y[..., None] / dim_t
    # even channels -> sin, odd -> cos (paired channels share dim_t)
    return torch.where(i % 2 == 0, torch.sin(pos), torch.cos(pos))


class PositionEmbeddingLearned(nn.Module):
    """Learned absolute time embedding, broadcast over frequency."""

    def __init__(self, num_pos_feats: int = 256, max_positions: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(max_positions, num_pos_feats)
        nn.init.uniform_(self.row_embed.weight, 0.0, 1.0)

    def forward(self, pad_mask: torch.Tensor) -> torch.Tensor:
        b, t, f = pad_mask.shape
        idx = torch.arange(t, device=pad_mask.device).clamp(max=self.row_embed.num_embeddings - 1)
        pos = self.row_embed(idx)  # [T', D]
        return pos[None, :, None, :].expand(b, t, f, pos.shape[-1])
