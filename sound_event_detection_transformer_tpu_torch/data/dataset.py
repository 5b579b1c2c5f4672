"""Datasets on metadata rows, and batches from them: multi-stream
composition, collation, prefetch.

Counterpart of the JAX package's ``data/dataset.py``:

* :class:`DataLoadDf`: per-clip ``.npy`` features (optionally held in RAM),
  the clip's labels encoded, the host transform, and the SP-SEDT patch
  branch; :class:`WavLoadDf`: the clip's raw waveform instead, padded or
  cropped to a fixed length (``--from_wavs``).  Both read the rows of
  ``features.SedData`` (dicts from ``data/tsv.py``) where the JAX package
  reads a DataFrame;
* :class:`ConcatDataset` and :class:`MultiStreamBatchSampler`: a fixed
  sub-batch from each stream (strong, weak, unlabeled), with the same
  ``np.random.RandomState`` permutations as the JAX package, so one seed
  draws the same batches in both;
* :func:`collate`: samples -> a dense :class:`engine.Batch` on the CPU;
* :class:`Prefetcher`: a host thread that collates the next batches while
  the card runs the current one;
* :func:`batch_iterator`: all of the above, with the −1 rows that pad the
  last batch, and with a :class:`~.feature_bank.FeatureBank` in place of the
  features;
* :func:`weak_batches`: the audio-tag trainer's (features, many-hot labels)
  pairs, on a :class:`Prefetcher`'s thread.

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
from .features import read_audio
from .transforms import extract_patches, get_random_patch_boxes
from .tsv import unique

PREFETCH_DEPTH = 2  # batches the host thread builds ahead of the consumer
STRONG_COLUMNS = {"onset", "offset", "event_label"}


def _no_events() -> Dict:
    """The labels of a clip when a dataset has no encoder (a 10 s clip, as in
    the JAX package)."""
    return {"labels": np.zeros((0,), np.int64), "boxes": np.zeros((0, 2), np.float32),
            "orig_size": np.asarray(10.0)}


class DataLoadDf:
    """Clip ``i`` of metadata ``rows`` (``features.SedData``'s, one or more
    rows a clip): ``dataset[i]`` is (features [T, F] after ``transform``,
    encoded labels).

    The labels per clip: strong rows ``(filename, onset, offset,
    event_label)`` when the rows have those columns, the comma-split
    ``event_labels`` of the clip's first row for weak rows (an empty cell is
    no label), else "empty".  They are gathered once, not looked up per
    call.  ``in_memory`` keeps every clip's raw features after their first
    read; ``cache_transformed`` keeps every clip's (features, labels) after
    the transform (exact: the transform is deterministic and the random
    augmentations run on the device), off on the patch path.

    With ``num_patches`` (SP-SEDT), every call draws that many random patch
    boxes from ``rng`` (``transforms.get_random_patch_boxes``), encoded as
    unlabeled; the patches are cropped on the host, or, with
    ``device_patches``, gathered on the device from the boxes.
    """

    def __init__(
        self,
        rows: Sequence[Dict],
        encode_function: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        in_memory: bool = False,
        num_patches: Optional[int] = None,
        sigma: float = 0.26,
        mu: float = 0.2,
        fixed_patch_size: bool = False,
        rng: Optional[np.random.RandomState] = None,
        device_patches: bool = False,
        cache_transformed: bool = False,
    ):
        self.rows = list(rows)
        self.encode_function = encode_function
        self.transform = transform
        self.in_memory = in_memory
        self.num_patches = num_patches
        self.sigma, self.mu = sigma, mu
        self.fixed_patch_size = fixed_patch_size
        self.device_patches = device_patches
        self.cache_transformed = cache_transformed and num_patches is None
        self._tcache: Dict[int, Tuple[np.ndarray, Dict]] = {}
        self._ycache: Dict[int, Dict] = {}  # targets_only memo (bank mode)
        self.rng = rng or np.random.RandomState()
        self.feat_filenames = unique(r["feature_filename"] for r in self.rows)
        self.filenames = unique(r["filename"] for r in self.rows)
        self._cache: Dict[str, np.ndarray] = {}
        self._labels = self._raw_labels()

    def _raw_labels(self) -> Dict[str, object]:
        columns = set(self.rows[0]) if self.rows else set()
        by_file: Dict[str, list] = {f: [] for f in self.filenames}
        for r in self.rows:
            by_file[r["filename"]].append(r)
        if STRONG_COLUMNS <= columns:
            return {f: [(r["filename"], r["onset"], r["offset"], r["event_label"]) for r in rs]
                    for f, rs in by_file.items()}
        if "event_labels" in columns:
            tags = lambda v: v.split(",") if isinstance(v, str) else []
            return {f: tags(rs[0]["event_labels"]) for f, rs in by_file.items()}
        return {f: "empty" for f in self.filenames}

    def __len__(self) -> int:
        return len(self.feat_filenames)

    def _features(self, path: str) -> np.ndarray:
        if not self.in_memory:
            return np.load(path).astype(np.float32)
        if path not in self._cache:
            self._cache[path] = np.load(path).astype(np.float32)
        return self._cache[path]

    def _raw_label(self, index: int):
        return self._labels[self.filenames[index]]

    def _encode(self, index: int) -> Dict:
        if self.encode_function is None:
            return _no_events()
        return self.encode_function(self._raw_label(index))

    def _patch_targets(self, t: int) -> Dict:
        """Fresh random patch boxes over ``t`` frames, encoded as unlabeled."""
        boxes = get_random_patch_boxes(t, self.num_patches, self.mu, self.sigma,
                                       self.fixed_patch_size, self.rng)
        if hasattr(self.encode_function, "__self__"):
            y = dict(self.encode_function.__self__.encode_unlabel(boxes))
        else:
            y = {"labels": np.zeros(len(boxes), np.int64), "orig_size": np.asarray(10.0)}
        y["boxes"] = boxes
        return y

    def features_only(self, index: int) -> Tuple[np.ndarray, int]:
        """The transformed features and the RAW frame count (before padding),
        without label work: the feature bank's protocol.  Exact, since the
        transform never reads the label."""
        data = self._features(self.feat_filenames[index])
        t_raw = data.shape[0]
        if self.transform is not None:
            data, _ = self.transform((data, None))
        return data, t_raw

    def targets_only(self, index: int, t_raw: int) -> Dict:
        """The labels ``dataset[index]`` would give, without feature work.  On
        the patch path it draws fresh boxes from ``rng`` in ``__getitem__``'s
        order; otherwise it is memoised."""
        if self.num_patches is not None:
            y = self._patch_targets(t_raw)
            y.pop("patches", None)  # crops are gathered on the device
            return y
        if index not in self._ycache:
            self._ycache[index] = self._encode(index)
        return self._ycache[index]

    def __getitem__(self, index: int) -> Tuple[np.ndarray, Dict]:
        if self.cache_transformed and index in self._tcache:
            return self._tcache[index]
        data = self._features(self.feat_filenames[index])
        y = self._patch_targets(data.shape[0]) if self.num_patches is not None else self._encode(index)
        if self.transform is not None:
            data, y = self.transform((data, y))
        if self.num_patches is not None:
            y = dict(y)
            if self.device_patches:
                y.pop("patches", None)  # crops are gathered on the device
            else:
                y["patches"] = extract_patches(data, y["boxes"])
        if self.cache_transformed:
            self._tcache[index] = (data, y)
        return data, y


class WavLoadDf(DataLoadDf):
    """:class:`DataLoadDf` whose features are the clip's raw waveform, read
    from ``wav_filename`` at ``sr``, zero-padded or cropped to ``n_samples``
    ([n_samples] float32; ``--from_wavs``, where the train step runs the
    frontend on the device).  The labels are the parent's; there is no host
    transform and no patch branch.  ``features_only`` returns the waveform
    and ``n_samples``."""

    def __init__(self, rows, encode_function=None, n_samples: int = 0, sr: int = 16000,
                 in_memory: bool = False):
        super().__init__(rows, encode_function, transform=None, in_memory=in_memory)
        if n_samples <= 0:
            raise ValueError(f"n_samples must be positive, not {n_samples}")
        if self.rows and "wav_filename" not in self.rows[0]:
            raise ValueError("WavLoadDf needs rows with a wav_filename (SedData's)")
        self.n_samples, self.sr = n_samples, sr
        self.wav_filenames = unique(r["wav_filename"] for r in self.rows)

    def _load_wav(self, path: str) -> np.ndarray:
        y, _ = read_audio(path, self.sr)
        if len(y) < self.n_samples:
            y = np.pad(y, (0, self.n_samples - len(y)))
        return y[:self.n_samples].astype(np.float32)

    def _features(self, path: str) -> np.ndarray:
        if not self.in_memory:
            return self._load_wav(path)
        if path not in self._cache:
            self._cache[path] = self._load_wav(path)
        return self._cache[path]

    def features_only(self, index: int) -> Tuple[np.ndarray, int]:
        return self._features(self.wav_filenames[index]), self.n_samples

    def __getitem__(self, index: int) -> Tuple[np.ndarray, Dict]:
        return self._features(self.wav_filenames[index]), self._encode(index)


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
    ``unlabel_flags`` are neither strong nor weak.  Waveforms [N] give feats
    [B, N, 1] and a [B, 1] mask: the step's frontend makes the real one."""
    feats = torch.from_numpy(np.stack([s[0] for s in samples]).astype(np.float32)[..., None])
    frames = feats.shape[1] if feats.dim() == 4 else 1
    return _batch(feats, [s[1] for s in samples], max_events, seconds, indexes, unlabel_flags,
                  frames)


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


def collate_weak(samples: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(features [T, F], many-hot [C]), ...] -> (features [B, T, F, 1], labels
    [B, C]), f32 on the CPU."""
    x = torch.from_numpy(np.stack([s[0] for s in samples]).astype(np.float32)[..., None])
    y = torch.from_numpy(np.stack([np.asarray(s[1], np.float32) for s in samples]))
    return x, y


def weak_batches(dataset, index_batches: Sequence[Sequence[int]],
                 pin_memory: bool = False) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`collate_weak` of ``dataset`` at each index list, built on a
    :class:`Prefetcher`'s thread (pinned with ``pin_memory``); a ragged last
    list gives a smaller batch."""

    def gen():
        for idxs in index_batches:
            x, y = collate_weak([dataset[i] for i in idxs])
            yield (x.pin_memory(), y.pin_memory()) if pin_memory else (x, y)

    return iter(Prefetcher(gen))
