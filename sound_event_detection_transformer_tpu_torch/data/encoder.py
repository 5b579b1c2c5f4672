"""Box label codec and the bridge to dense targets.

Counterpart of the JAX package's ``data/encoder.py`` for the evaluation path:
encoding of list labels, the weak and strong decoders, and
:func:`to_dense_targets`.  Host-side numpy; pandas inputs are not handled.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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

    def encode_weak(self, labels) -> Dict[str, np.ndarray]:
        """Clip-level labels ("a,b", "empty" or a list) -> class ids only."""
        if isinstance(labels, str):
            labels = [] if labels == "empty" else labels.split(",")
        ids = [self._index(lbl) for lbl in labels
               if lbl is not None and not (isinstance(lbl, float) and np.isnan(lbl))]
        return {
            "labels": np.asarray(ids, dtype=np.int64),
            "boxes": np.zeros((0,), dtype=np.float32),
            "orig_size": np.asarray(self.seconds),
        }

    def encode_strong_df(self, label_list) -> Dict[str, np.ndarray]:
        """[[label, onset_s, offset_s], ...] (or "empty", or plain labels) ->
        class ids + [(on + off) / 2s, (off - on) / s] boxes."""
        labels, boxes = [], []
        if not isinstance(label_list, str):  # a string is 'empty'
            for ev in label_list:
                if isinstance(ev, str):
                    if ev != "":
                        labels.append(self._index(ev))
                elif len(ev) == 3:
                    if ev[0] != "":
                        labels.append(self._index(ev[0]))
                        on, off = float(ev[1]) / self.seconds, float(ev[2]) / self.seconds
                        boxes.append([(on + off) / 2, off - on])
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
