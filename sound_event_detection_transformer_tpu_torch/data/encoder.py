"""Label codecs and the bridge to dense targets.

Counterpart of the JAX package's ``data/encoder.py``: the box encoder (events
<-> normalized 1-D time boxes) with its weak, strong and unlabeled encodings
and decoders, the frame-level ``ManyHotEncoder``, and
:func:`to_dense_targets`.  Host-side numpy.  Where the JAX package reads a
DataFrame of strong labels, the port reads rows
``(filename, onset, offset, event_label)``; a row whose label is None (or
NaN) marks a file without events.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.criterion import DenseTargets


class BoxEncoder:
    """Strong/weak event labels <-> normalized (center, length) boxes."""

    def __init__(self, labels, seconds: float):
        if isinstance(labels, np.ndarray):
            labels = labels.tolist()
        self.labels = list(labels) if not isinstance(labels, int) else labels
        self.seconds = seconds

    def _index(self, label: str) -> int:
        return 0 if isinstance(self.labels, int) else int(self.labels.index(label))

    def encode_unlabel(self, boxes) -> Dict[str, np.ndarray]:
        """Patch or unlabeled encoding: class 0 for every box."""
        return {
            "labels": np.asarray([0] * len(boxes), dtype=np.int64),
            "boxes": np.asarray(boxes, dtype=np.float32),
            "orig_size": np.asarray(self.seconds),
        }

    def encode_weak(self, labels) -> Dict[str, np.ndarray]:
        """Clip-level labels ("a,b", "empty" or a list) -> class ids only."""
        if isinstance(labels, str):
            labels = [] if labels == "empty" else labels.split(",")
        ids = [self._index(lbl) for lbl in labels if not missing_label(lbl)]
        return {
            "labels": np.asarray(ids, dtype=np.int64),
            "boxes": np.zeros((0,), dtype=np.float32),
            "orig_size": np.asarray(self.seconds),
        }

    def encode_strong_df(self, label_list) -> Dict[str, np.ndarray]:
        """[[label, onset_s, offset_s], ...], one file's rows
        ``(filename, onset_s, offset_s, event_label)``, "empty" or plain
        labels -> class ids + [(on + off) / 2s, (off - on) / s] boxes."""
        labels, boxes = [], []

        def add(label, onset, offset):
            labels.append(self._index(label))
            on, off = float(onset) / self.seconds, float(offset) / self.seconds
            boxes.append([(on + off) / 2, off - on])

        if not isinstance(label_list, str):  # a string is 'empty'
            for ev in label_list:
                if isinstance(ev, str):
                    if ev != "":
                        labels.append(self._index(ev))
                elif len(ev) == 3:
                    if ev[0] != "":
                        add(ev[0], ev[1], ev[2])
                elif len(ev) == 4:  # a table row
                    if not missing_label(ev[3]):
                        add(ev[3], ev[1], ev[2])
                else:
                    raise NotImplementedError(type(ev))
        return {
            "labels": np.asarray(labels, dtype=np.int64),
            "boxes": np.asarray(boxes, dtype=np.float32),
            "orig_size": np.asarray(self.seconds),
        }

    def decode_weak(self, labels) -> List[str]:
        return [self.labels[i] for i, v in enumerate(labels) if v == 1]

    def decode_strong(self, labels: Dict[str, np.ndarray], threshold: float = 0.5,
                      del_overlap: bool = True, min_duration: float = 0.2) -> List[List]:
        """Per-query (score, label, box) -> [[label, onset, offset, score], ...]
        with the min-duration filter and same-class greedy overlap removal."""
        scores = np.asarray(labels["scores"])
        cls = np.asarray(labels["labels"])
        boxes = np.asarray(labels["boxes"])
        result = []
        if not del_overlap:
            for i in range(len(scores)):
                if scores[i] > threshold:
                    onset, offset = boxes[i]
                    if offset - onset >= min_duration:
                        result.append([self.labels[cls[i]], onset, offset, scores[i]])
            return result
        if isinstance(self.labels, int):
            raise ValueError("del_overlap needs class names, not a single-class encoder")
        event_dict: Dict[str, List[np.ndarray]] = {}
        for i in range(len(scores)):
            if scores[i] >= threshold:
                onset, offset = boxes[i]
                if offset - onset >= min_duration:
                    event_dict.setdefault(self.labels[cls[i]], []).append(
                        np.asarray([scores[i], onset, offset]))
        for event, rows in event_dict.items():
            arr = np.vstack(rows)
            arr = arr[np.argsort(arr[:, 1])]  # by onset
            i = 1
            while i < len(arr):
                if arr[i][1] < arr[i - 1][2]:  # overlaps the previous event
                    arr = np.delete(arr, i - 1 if arr[i][0] > arr[i - 1][0] else i, axis=0)
                    continue
                i += 1
            for row in arr:
                result.append([event, row[1], row[2], row[0]])
        return result

    def decode_strong_batch(self, scores, labels, boxes, threshold: float = 0.5,
                            min_duration: float = 0.2) -> Dict[int, List[List]]:
        """[B, Q] arrays -> {sample: decode_strong(sample)} for the samples
        with at least one event past the score and duration filters."""
        scores = np.asarray(scores)
        labels = np.asarray(labels)
        boxes = np.asarray(boxes)
        keep = (scores >= threshold) & ((boxes[..., 1] - boxes[..., 0]) >= min_duration)
        out: Dict[int, List[List]] = {}
        for b in np.nonzero(keep.any(axis=1))[0]:
            k = keep[b]
            out[int(b)] = self.decode_strong(
                {"scores": scores[b][k], "labels": labels[b][k], "boxes": boxes[b][k]},
                threshold=threshold, min_duration=min_duration,
            )
        return out

    def state_dict(self):
        return {"labels": self.labels, "n_frames": self.seconds}

    @classmethod
    def load_state_dict(cls, state_dict):
        return cls(state_dict["labels"], state_dict["n_frames"])


def missing_label(label) -> bool:
    """A row's label that marks "no event": None or NaN."""
    return label is None or (isinstance(label, float) and np.isnan(label))


class ManyHotEncoder:
    """Frame-level multi-hot codec: weak labels -> [C] multi-hot, strong rows
    -> [n_frames, C] (onsets and offsets in frames), decoded by contiguous
    regions."""

    def __init__(self, labels, n_frames: Optional[int] = None):
        if isinstance(labels, np.ndarray):
            labels = labels.tolist()
        self.labels = list(labels)
        self.n_frames = n_frames

    def encode_weak(self, labels) -> np.ndarray:
        y = np.zeros(len(self.labels), dtype=np.float32)
        if isinstance(labels, str):
            labels = [] if labels == "empty" else labels.split(",")
        for label in labels:
            if not missing_label(label):
                y[self.labels.index(label)] = 1
        return y

    def encode_strong_df(self, rows) -> np.ndarray:
        """One file's rows ``(filename, onset, offset, event_label)``."""
        if self.n_frames is None:
            raise ValueError("encode_strong_df needs n_frames")
        y = np.zeros((self.n_frames, len(self.labels)), dtype=np.float32)
        for _, onset, offset, label in (r[:4] for r in rows):
            if not missing_label(label):
                y[int(round(onset)):int(round(offset)), self.labels.index(label)] = 1
        return y

    @staticmethod
    def find_contiguous_regions(activity: np.ndarray) -> np.ndarray:
        """[T] 0/1 -> [n, 2] (onset, offset) frame indices."""
        change = np.logical_xor(activity[1:], activity[:-1]).nonzero()[0] + 1
        if activity[0]:
            change = np.r_[0, change]
        if activity[-1]:
            change = np.r_[change, len(activity)]
        return change.reshape(-1, 2)

    def decode_strong(self, labels: np.ndarray) -> List[List]:
        result = []
        for i, label_col in enumerate(labels.T):
            for row in self.find_contiguous_regions(label_col > 0.5):
                result.append([self.labels[i], row[0], row[1]])
        return result

    def decode_weak(self, labels) -> List[str]:
        return [self.labels[i] for i, v in enumerate(labels) if v == 1]

    def state_dict(self):
        return {"labels": self.labels, "n_frames": self.n_frames}

    @classmethod
    def load_state_dict(cls, state_dict):
        return cls(state_dict["labels"], state_dict["n_frames"])


def to_dense_targets(
    encoded: Sequence[Dict[str, np.ndarray]],
    max_events: int,
    seconds: float,
) -> Tuple[DenseTargets, torch.Tensor, torch.Tensor]:
    """Ragged encoder outputs -> (DenseTargets on the CPU, strong, weak flags).
    Events beyond ``max_events`` are dropped."""
    b, m = len(encoded), max_events
    labels = np.zeros((b, m), np.int32)
    boxes = np.zeros((b, m, 2), np.float32)
    box_valid = np.zeros((b, m), bool)
    label_valid = np.zeros((b, m), bool)
    ratio = np.ones((b, m), np.float32)
    orig = np.full((b,), seconds, np.float32)
    strong = np.zeros((b,), bool)
    weak = np.zeros((b,), bool)
    for i, y in enumerate(encoded):
        ls = np.asarray(y.get("labels", []), dtype=np.int64).reshape(-1)
        bs = np.asarray(y.get("boxes", []), dtype=np.float32).reshape(-1, 2)
        nl = min(len(ls), m)
        nb = min(len(bs), m, nl)
        labels[i, :nl] = ls[:nl]
        label_valid[i, :nl] = True
        boxes[i, :nb] = bs[:nb]
        box_valid[i, :nb] = True
        if "orig_size" in y and np.size(y["orig_size"]):
            orig[i] = float(np.asarray(y["orig_size"]).reshape(-1)[0])
        strong[i] = nb > 0
        weak[i] = nb == 0 and nl > 0
    t = lambda a: torch.from_numpy(a)
    return (
        DenseTargets(t(labels), t(boxes), t(box_valid), t(label_valid), t(ratio), t(orig)),
        t(strong),
        t(weak),
    )
