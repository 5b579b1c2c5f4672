"""1-D time-box operations on (center, length) and (start, end) boxes.

Boxes live on [0, 1] normalized time.  Every function is batched over any
leading dims and mirrors the function of the same name in the JAX package.
"""
from __future__ import annotations

import torch


def box_cl_to_se(x: torch.Tensor) -> torch.Tensor:
    """(center, length) -> (start, end)."""
    c, l = x[..., 0], x[..., 1]
    return torch.stack([c - l / 2, c + l / 2], dim=-1)


def box_se_to_cl(x: torch.Tensor) -> torch.Tensor:
    """(start, end) -> (center, length)."""
    s, e = x[..., 0], x[..., 1]
    return torch.stack([(s + e) / 2, e - s], dim=-1)


def box_length(se: torch.Tensor) -> torch.Tensor:
    return se[..., 1] - se[..., 0]


def box_iou(se1: torch.Tensor, se2: torch.Tensor):
    """Pairwise IoU: se1 [..., N, 2], se2 [..., M, 2] -> (iou, union) [..., N, M]."""
    len1 = box_length(se1)
    len2 = box_length(se2)
    lt = torch.maximum(se1[..., :, None, 0], se2[..., None, :, 0])
    rb = torch.minimum(se1[..., :, None, 1], se2[..., None, :, 1])
    inter = (rb - lt).clamp(min=0.0)
    union = len1[..., :, None] + len2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(se1: torch.Tensor, se2: torch.Tensor) -> torch.Tensor:
    """Pairwise 1-D GIoU = IoU - (hull - union) / hull."""
    iou, union = box_iou(se1, se2)
    lt = torch.minimum(se1[..., :, None, 0], se2[..., None, :, 0])
    rb = torch.maximum(se1[..., :, None, 1], se2[..., None, :, 1])
    hull = (rb - lt).clamp(min=0.0)
    return iou - (hull - union) / hull.clamp(min=1e-9)


def elementwise_l1_se(se1: torch.Tensor, se2: torch.Tensor) -> torch.Tensor:
    """Aligned L1 distance in (start, end) space: [..., 2] -> [...]."""
    return (se1 - se2).abs().sum(-1)


def pairwise_l1_se(se1: torch.Tensor, se2: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 cost: se1 [..., N, 2], se2 [..., M, 2] -> [..., N, M]."""
    return (se1[..., :, None, :] - se2[..., None, :, :]).abs().sum(-1)


def elementwise_giou_se(se1: torch.Tensor, se2: torch.Tensor) -> torch.Tensor:
    """Aligned 1-D GIoU for matched pairs; se*: [..., 2]."""
    len1 = box_length(se1)
    len2 = box_length(se2)
    lt = torch.maximum(se1[..., 0], se2[..., 0])
    rb = torch.minimum(se1[..., 1], se2[..., 1])
    inter = (rb - lt).clamp(min=0.0)
    union = len1 + len2 - inter
    iou = inter / union.clamp(min=1e-9)
    hull_lt = torch.minimum(se1[..., 0], se2[..., 0])
    hull_rb = torch.maximum(se1[..., 1], se2[..., 1])
    hull = (hull_rb - hull_lt).clamp(min=0.0)
    return iou - (hull - union) / hull.clamp(min=1e-9)
