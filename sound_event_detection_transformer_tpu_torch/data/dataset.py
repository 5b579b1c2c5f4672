"""Batches from datasets: multi-stream composition, collation, prefetch.

Counterpart of the JAX package's ``data/dataset.py`` for in-memory datasets:

* :class:`ConcatDataset` and :class:`MultiStreamBatchSampler`: a fixed
  sub-batch from each stream (strong, weak, unlabeled), with the same
  ``np.random.RandomState`` permutations as the JAX package, so one seed
  draws the same batches in both;
* :func:`collate`: samples -> a dense :class:`engine.Batch` on the CPU;
* :class:`Prefetcher`: a host thread that collates the next batches while
  the card runs the current one;
* :func:`batch_iterator`: all of the above, with the −1 rows that pad the
  last batch, and with a :class:`~.feature_bank.FeatureBank` in place of the
  features.

Batches stay on the host; the steps move them to the card.  With
``pin_memory`` the iterator pins them, so those copies run asynchronously.
"""
from __future__ import annotations

import bisect
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import Batch
from ..models.criterion import DenseTargets
from .encoder import to_dense_targets

PREFETCH_DEPTH = 2  # batches the host thread builds ahead of the consumer


class ConcatDataset:
    """Datasets end to end, with each source's range of indices."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets]).tolist()

    @property
    def cluster_indices(self) -> List[range]:
        out, prev = [], 0
        for size in self.cumulative_sizes:
            out.append(range(prev, size))
            prev = size
        return out

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx: int):
        d = bisect.bisect_right(self.cumulative_sizes, idx)
        local = idx if d == 0 else idx - self.cumulative_sizes[d - 1]
        return self.datasets[d], local

    def __getitem__(self, idx: int):
        d, local = self._locate(idx)
        return d[local]

    def features_only(self, idx: int):
        d, local = self._locate(idx)
        return d.features_only(local)

    def targets_only(self, idx: int, t_raw: int):
        d, local = self._locate(idx)
        return d.targets_only(local, t_raw)

    @property
    def filenames(self) -> List[str]:
        return [f for d in self.datasets for f in d.filenames]


class MultiStreamBatchSampler:
    """Batches of ``batch_sizes[k]`` indices from stream ``k`` each, from one
    permutation of every stream per pass."""

    def __init__(self, data_source: ConcatDataset, batch_sizes: Sequence[int],
                 shuffle: bool = True, seed: Optional[int] = None):
        self.data_source = data_source
        self.batch_sizes = list(batch_sizes)
        if len(self.batch_sizes) != len(data_source.cluster_indices):
            raise ValueError(f"{len(self.batch_sizes)} batch sizes for "
                             f"{len(data_source.cluster_indices)} streams")
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        clusters = [np.array(list(c)) for c in self.data_source.cluster_indices]
        if self.shuffle:
            clusters = [self.rng.permutation(c) for c in clusters]
        for b in range(len(self)):
            batch: List[int] = []
            for c, bs in zip(clusters, self.batch_sizes):
                batch.extend(c[b * bs:(b + 1) * bs].tolist())
            yield batch

    def __len__(self) -> int:
        return min(len(c) // bs
                   for c, bs in zip(self.data_source.cluster_indices, self.batch_sizes))


def collate(
    samples: Sequence[Tuple[np.ndarray, Dict]],
    max_events: int,
    seconds: float,
    indexes: Optional[Sequence[int]] = None,
    unlabel_flags: Optional[np.ndarray] = None,
) -> Batch:
    """[(features [T, F], encoded labels), ...] -> Batch on the CPU, with an
    all-False pad mask (clips come at full length).  Rows flagged in
    ``unlabel_flags`` are neither strong nor weak."""
    feats = torch.from_numpy(np.stack([s[0] for s in samples]).astype(np.float32)[..., None])
    return _batch(feats, [s[1] for s in samples], max_events, seconds, indexes, unlabel_flags,
                  feats.shape[1])


def _batch(feats, encoded, max_events, seconds, indexes, unlabel_flags, frames) -> Batch:
    targets, strong, weak = to_dense_targets(encoded, max_events, seconds)
    if unlabel_flags is not None:
        unlabel = torch.from_numpy(np.asarray(unlabel_flags, bool))
        strong, weak = strong & ~unlabel, weak & ~unlabel
    pad_mask = torch.zeros((len(encoded), frames), dtype=torch.bool)
    idx = torch.as_tensor(np.asarray(indexes, np.int32)) if indexes is not None else None
    return Batch(feats=feats, pad_mask=pad_mask, targets=targets, strong=strong, weak=weak,
                 indexes=idx)


def _pinned(b: Batch) -> Batch:
    pin = lambda t: None if t is None else t.pin_memory()
    return Batch(feats=pin(b.feats), pad_mask=pin(b.pad_mask),
                 targets=DenseTargets(*(pin(t) for t in b.targets)), strong=pin(b.strong),
                 weak=pin(b.weak), indexes=pin(b.indexes))


class Prefetcher:
    """Runs ``make_iter()`` on a host thread, ``PREFETCH_DEPTH`` items ahead.

    An exception in the thread is raised in the consumer.  A consumer that
    stops early (or fails) lets the thread end at its next item.
    """

    def __init__(self, make_iter: Callable[[], Iterator]):
        self.make_iter = make_iter

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        cancel = threading.Event()

        def worker():
            try:
                for item in self.make_iter():
                    if cancel.is_set():
                        return
                    q.put((True, item))
                q.put((False, None))
            except BaseException as exc:  # handed to the consumer, which raises it
                q.put((False, exc))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                more, item = q.get()
                if not more:
                    if item is not None:
                        raise item
                    return
                yield item
        finally:
            cancel.set()
            while t.is_alive():  # unblock a put on a full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass


def batch_iterator(
    dataset,
    sampler_or_batchsize,
    max_events: int,
    seconds: float,
    unlabel_streams: Optional[Sequence[int]] = None,
    return_indexes: bool = False,
    bank=None,
    pin_memory: bool = False,
) -> Iterator[Batch]:
    """Batches of ``dataset`` from a sampler (an iterable of index lists) or
    in order at a batch size, built on a :class:`Prefetcher`'s thread.

    In order, the last batch is filled up with its final sample, so every
    batch has one shape; with ``return_indexes`` the filled rows carry index
    −1, which the evaluation skips.  ``unlabel_streams``:
    the streams (of a :class:`ConcatDataset`) whose rows are unlabeled.
    ``bank``: a :class:`~.feature_bank.FeatureBank`; batches then carry
    ``feats=None`` and always their ``indexes``, and the consumer gathers the
    features on the card (``bank.gather(batch.indexes)``).  ``pin_memory``
    pins every batch for asynchronous copies to the card.
    """

    def gen():
        pad_counts = {}
        if isinstance(sampler_or_batchsize, int):
            n, bs = len(dataset), sampler_or_batchsize
            index_batches = []
            for i in range(0, n, bs):
                b = list(range(i, min(i + bs, n)))
                if len(b) < bs:
                    pad_counts[len(index_batches)] = bs - len(b)
                    b = b + [b[-1]] * (bs - len(b))
                index_batches.append(b)
        else:
            index_batches = sampler_or_batchsize
        bounds = None
        if unlabel_streams and hasattr(dataset, "cumulative_sizes"):
            bounds = [0] + list(dataset.cumulative_sizes)

        for bi, idxs in enumerate(index_batches):
            idxs = list(idxs)
            uflags = None
            if bounds is not None:
                uflags = np.array([bisect.bisect_right(bounds, i) - 1 in unlabel_streams
                                   for i in idxs])
            out_idxs = None
            if return_indexes:
                out_idxs = list(idxs)
                for k in range(pad_counts.get(bi, 0)):
                    out_idxs[len(out_idxs) - 1 - k] = -1  # padded row marker
            if bank is not None:
                ys = [dataset.targets_only(i, bank.raw_frames[i]) for i in idxs]
                b = _batch(None, ys, max_events, seconds,
                           out_idxs if out_idxs is not None else idxs, uflags, bank.shape[1])
            else:
                b = collate([dataset[i] for i in idxs], max_events, seconds, out_idxs, uflags)
            yield _pinned(b) if pin_memory else b

    return iter(Prefetcher(gen))
