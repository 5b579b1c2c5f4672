"""Batch collation: samples -> a dense :class:`engine.Batch` (the JAX
package's ``data/dataset.collate`` for feature batches)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import Batch
from .encoder import to_dense_targets


def collate(
    samples: Sequence[Tuple[np.ndarray, Dict]],
    max_events: int,
    seconds: float,
    indexes: Optional[Sequence[int]] = None,
) -> Batch:
    """[(features [T, F], encoded labels), ...] -> Batch on the CPU, with an
    all-False pad mask (clips come at full length)."""
    feats = torch.from_numpy(np.stack([s[0] for s in samples]).astype(np.float32)[..., None])
    targets, strong, weak = to_dense_targets([s[1] for s in samples], max_events, seconds)
    pad_mask = torch.zeros(feats.shape[:2], dtype=torch.bool)
    idx = torch.as_tensor(np.asarray(indexes, np.int32)) if indexes is not None else None
    return Batch(feats=feats, pad_mask=pad_mask, targets=targets, strong=strong,
                 weak=weak, indexes=idx)
