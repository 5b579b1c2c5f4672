"""Device-resident feature bank: the dataset's features live on the card and
each batch is gathered there.

Counterpart of the JAX package's ``data/feature_bank.py``.  The features of
every clip are stacked once and moved to the device; a batch then costs the
host only its indices and its dense targets.  Valid because the features
never depend on the labels or on a random draw: the augmentations run on the
device, inside the step.

Two layouts: replicated (one process holds every clip, the gather is local)
and sharded over the data axis (``shard=True``: each data rank holds a
contiguous 1/N of the clips, the row count padded with zero rows to a
multiple of N, which no index reaches).  A sharded gather takes the GLOBAL
batch's indices on every rank: each rank takes the rows it holds (zeros for
the others), one ``all_reduce`` sums them, and each rank keeps its
contiguous chunk of the sum, which is its share of the batch.  That is the
JAX package's psum-then-scatter with the collective that both NCCL and gloo
offer on CUDA tensors.  The collectives run over the data group: the ranks
of one model group hold the same shard (JAX shards the bank over ``data``
only), and a sum over the world would count every row ``n_model`` times.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distribute import comm_device, data_group, data_rank, data_world

BANK_BUDGET_BYTES = 8e9  # the largest bank (or bank share) the trainer puts on a card


class FeatureBank:
    """``dataset.features_only(i)`` for every clip (``shard=False``) or for
    this rank's contiguous share of the clips (``shard=True``), stacked into
    one [rows, T, F, 1] float32 tensor on ``device``.  ``raw_frames`` holds
    every clip's frame count before padding on every rank (merged over the
    ranks when sharded), so any rank builds targets for any clip."""

    def __init__(self, dataset, device: torch.device, log=None, shard: bool = False):
        self.sharded = bool(shard)
        self.rank, self.world = (data_rank(), data_world()) if shard else (0, 1)
        n = len(dataset)
        self.shard_size = -(-n // self.world)
        lo = self.rank * self.shard_size
        rows = range(lo, min(lo + self.shard_size, n))
        raw = np.zeros(n, np.int64)
        feats = []
        for i in rows:
            feat, t_raw = dataset.features_only(i)
            feats.append(np.asarray(feat, np.float32))
            raw[i] = int(t_raw)
        sample = feats[0] if feats else np.asarray(dataset.features_only(0)[0], np.float32)
        arr = np.zeros((self.shard_size, *sample.shape, 1), np.float32)
        if feats:
            arr[:len(feats), ..., 0] = np.stack(feats)
        self.shape = (n, *sample.shape, 1)
        self.nbytes = n * sample.nbytes
        self._bank = torch.from_numpy(arr).to(device)
        self.device = self._bank.device
        if self.world > 1:  # one all_reduce merges the ranks' frame counts
            merged = torch.from_numpy(raw).to(comm_device())
            dist.all_reduce(merged, group=data_group())
            raw = merged.cpu().numpy()
        self.raw_frames = {i: int(t) for i, t in enumerate(raw)}
        if log is not None:
            layout = (f"sharded over {self.world} ranks ({self.shard_size} rows each)"
                      if shard else f"on {self.device}")
            log.info(f"device-resident feature bank: {self.shape} "
                     f"({self.nbytes / 1e9:.2f} GB) {layout}")

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, idx) -> torch.Tensor:
        """[G] row indices (a host tensor, pinned for an asynchronous copy,
        or one on the bank's device) -> the features on the device: [G, T, F,
        1] when replicated, this rank's contiguous [G / N, T, F, 1] share of
        the global batch ``idx`` when sharded (a collective: every rank calls
        it with the same ``idx``).  A negative index (a padded row) reads row
        0."""
        idx = torch.as_tensor(idx).to(self.device, non_blocking=True).long().clamp_min(0)
        if not self.sharded:
            return self._bank.index_select(0, idx)
        if idx.shape[0] % self.world:
            raise ValueError(f"a sharded gather of {idx.shape[0]} rows over {self.world} ranks")
        local = idx - self.rank * self.shard_size
        held = (local >= 0) & (local < self.shard_size)
        rows = self._bank.index_select(0, local.clamp(0, self.shard_size - 1))
        rows = torch.where(held.view(-1, *([1] * (rows.dim() - 1))), rows, 0.0)
        if self.world > 1:
            dist.all_reduce(rows, group=data_group())
        per = idx.shape[0] // self.world
        return rows[self.rank * per:(self.rank + 1) * per]


def maybe_bank(args, dataset, cfg, device: torch.device, log=None) -> Optional[FeatureBank]:
    """The JAX package's choice, in its order: with ``--device_data`` (the
    default), a replicated :class:`FeatureBank` when there is one process and
    the dataset fits in ``BANK_BUDGET_BYTES``; a sharded one when there are
    several processes, or ``--shard_bank``, or only a 1/N share fits; else
    None, and batches carry their features from the host."""
    if not getattr(args, "device_data", True):
        return None
    world = data_world()
    est = len(dataset) * cfg.model.max_frames * cfg.model.n_mels * 4
    if est <= BANK_BUDGET_BYTES and world == 1 and not getattr(args, "shard_bank", False):
        return FeatureBank(dataset, device, log=log)
    if est / world <= BANK_BUDGET_BYTES:
        return FeatureBank(dataset, device, log=log, shard=True)
    if log is not None:
        log.info(f"feature bank would need {est / world / 1e9:.1f} GB a rank; keeping the "
                 "host batch stream")
    return None
