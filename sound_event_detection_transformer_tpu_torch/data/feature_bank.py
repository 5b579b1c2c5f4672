"""Device-resident feature bank: the dataset's features live on the card and
each batch is gathered there.

Counterpart of the JAX package's ``data/feature_bank.py`` (its replicated
layout, for one process).  The features of every clip are stacked once and
moved to the device; a batch then costs the host only its indices and its
dense targets.  Valid because the features never depend on the labels or on
a random draw: the augmentations run on the device, inside the step.  The
layout sharded over several devices waits for multi-GPU (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

BANK_BUDGET_BYTES = 8e9  # the largest bank the trainer puts on the card


class FeatureBank:
    """``dataset.features_only(i)`` for every clip, stacked into one
    [N, T, F, 1] float32 tensor on ``device``."""

    def __init__(self, dataset, device: torch.device, log=None):
        feats = []
        self.raw_frames: dict = {}
        for i in range(len(dataset)):
            feat, t_raw = dataset.features_only(i)
            feats.append(np.asarray(feat, np.float32))
            self.raw_frames[i] = int(t_raw)
        arr = torch.from_numpy(np.stack(feats)[..., None])
        self.shape = tuple(arr.shape)
        self.nbytes = arr.numel() * arr.element_size()
        self._bank = arr.to(device)
        self.device = self._bank.device
        if log is not None:
            log.info(f"device-resident feature bank: {self.shape} "
                     f"({self.nbytes / 1e9:.2f} GB) on {self.device}")

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, idx) -> torch.Tensor:
        """[B] row indices (a host tensor, pinned for an asynchronous copy,
        or one on the bank's device) -> [B, T, F, 1] features on the device.
        A negative index (a padded row) reads row 0."""
        idx = torch.as_tensor(idx).to(self.device, non_blocking=True)
        return self._bank.index_select(0, idx.long().clamp_min(0))


def maybe_bank(args, dataset, cfg, device: torch.device, log=None) -> Optional[FeatureBank]:
    """A :class:`FeatureBank` when ``--device_data`` is on (the default) and
    the dataset fits in ``BANK_BUDGET_BYTES``; else None, and batches carry
    their features from the host."""
    if not getattr(args, "device_data", True):
        return None
    if getattr(args, "shard_bank", False):
        raise NotImplementedError(
            "--shard_bank: the bank sharded over devices waits for multi-GPU "
            "(ROADMAP queue 1, item 7)")
    est = len(dataset) * cfg.model.max_frames * cfg.model.n_mels * 4
    if est <= BANK_BUDGET_BYTES:
        return FeatureBank(dataset, device, log=log)
    if log is not None:
        log.info(f"feature bank would need {est / 1e9:.1f} GB; keeping the host batch stream")
    return None
