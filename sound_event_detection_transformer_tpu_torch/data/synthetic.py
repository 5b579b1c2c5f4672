"""Synthetic clips: noise-floor log-mel spectrograms with class-specific
energy blobs at known (onset, offset).  The same generator as the JAX
package's ``data/synthetic.py``, so one seed gives the same clips on both
sides."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def make_clip(
    rng: np.random.RandomState,
    classes: Sequence[str],
    frames: int,
    mels: int,
    max_events: int,
    seconds: float = 10.0,
    min_events: int = 1,
) -> Tuple[np.ndarray, List[Tuple[str, float, float]]]:
    """One synthetic log-mel clip + its event list (label, onset_s, offset_s)."""
    data = rng.randn(frames, mels).astype(np.float32) * 0.3 - 2.0
    n_events = rng.randint(min_events, max_events + 1)
    events = []
    for _ in range(n_events):
        ci = rng.randint(len(classes))
        dur = rng.uniform(0.08, 0.35)  # fraction of clip
        start = rng.uniform(0.0, 1.0 - dur)
        f0 = (ci * mels) // (len(classes) + 1)
        f1 = min(mels, f0 + max(3, mels // (len(classes) + 1)))
        t0, t1 = int(start * frames), int((start + dur) * frames)
        data[t0:t1, f0:f1] += 4.0 + rng.rand()
        events.append((classes[ci], start * seconds, (start + dur) * seconds))
    return data, events


class SyntheticDataset:
    """In-memory dataset of synthetic clips; ``dataset[i]`` is (features
    [frames, mels], encoded labels).

    Labels are strong by default, clip-level with ``weak_only`` and "empty"
    with ``unlabel``.  Clip ``i`` of seed ``s`` is named
    ``synthetic_{s}_{i}.wav``, as in the JAX package.
    """

    def __init__(
        self,
        n_clips: int,
        classes: Sequence[str],
        frames: int,
        mels: int,
        encode_function,
        max_events: int = 3,
        seconds: float = 10.0,
        seed: int = 0,
        weak_only: bool = False,
        unlabel: bool = False,
    ):
        rng = np.random.RandomState(seed)
        self.encode_function = encode_function
        self.items = []
        self.rows: List[Tuple[str, float, float, str]] = []
        self.filenames: List[str] = []
        for i in range(n_clips):
            data, events = make_clip(rng, classes, frames, mels, max_events, seconds)
            fname = f"synthetic_{seed}_{i}.wav"
            self.filenames.append(fname)
            if unlabel:
                label_arg = "empty"
            elif weak_only:
                label_arg = sorted({e[0] for e in events})
            else:
                label_arg = [[lbl, on, off] for lbl, on, off in events]
            self.items.append((data, label_arg))
            self.rows.extend((fname, on, off, lbl) for lbl, on, off in events)
        self.seconds = seconds
        self.frames = frames

    def ref_rows(self) -> List[Tuple[str, float, float, str]]:
        """The ground truth: one row ``(filename, onset, offset, event_label)``
        per planted event (every clip has at least one)."""
        return list(self.rows)

    def __len__(self):
        return len(self.items)

    def features_only(self, idx: int):
        """Features and their frame count (the feature bank's protocol)."""
        data = self.items[idx][0]
        return data, data.shape[0]

    def targets_only(self, idx: int, t_raw: int):
        """The label dict of ``dataset[idx]``, without the features."""
        return self.encode_function(self.items[idx][1])

    def __getitem__(self, idx: int):
        data, label_arg = self.items[idx]
        return data, self.encode_function(label_arg)
