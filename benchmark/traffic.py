"""The benchmark's one traffic generator: seeded clips, their events, the
batches a closed-loop trainer draws, and SP-SEDT's patch boxes.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters:
``batch``, ``events_per_clip`` [lo, hi], ``event_length`` [lo, hi] as a
share of the clip, ``check_steps`` (the steps the reference follows) and,
for patch pretraining, ``patch_length`` (mu, sigma and the range of a
normal draw).  The configuration gives the clip count, the frames, the mel
bands and the classes; an epoch is ``clips // batch`` steps.

Clips follow the port's synthetic pattern (``data/synthetic.py``): a noise
floor of N(-2, 0.3) and, for each event, a band of the clip's mels raised by
4 + U(0, 1) over the event's frames.  The noise is drawn on the device in
one call; the events on the host with numpy, all at once.  Every draw comes
from a sub-seed of ``--seed`` (:func:`sub_seeds`), so one seed gives one set
of clips, weights and batches, on every run.

The datasets hand the clips to the port through the protocol its
``FeatureBank`` and ``batch_iterator`` read (``features_only``,
``targets_only``, ``num_patches``) and encode labels with the port's encoder;
the reference rebuilds the same targets from :class:`Clips` alone.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

SEEDS = ("weights", "noise", "events", "sampler", "dropout", "patches", "check_order")


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds for each draw of a run, from one seed of any
    size."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(SEEDS))
    return {k: int(v) for k, v in zip(SEEDS, state)}


class Clips(NamedTuple):
    feats: np.ndarray  # [N, T, F] f32 on the host
    classes: np.ndarray  # [N, K] class ids
    start: np.ndarray  # [N, K] onset, share of the clip
    length: np.ndarray  # [N, K] length, share of the clip
    count: np.ndarray  # [N] events of each clip (the first ``count`` of K)


def make_clips(n: int, frames: int, mels: int, n_classes: int, traffic: Dict,
               seeds: Dict[str, int], device: torch.device) -> Clips:
    lo, hi = traffic["events_per_clip"]
    l_lo, l_hi = traffic["event_length"]
    rs = np.random.RandomState(seeds["events"])
    count = rs.randint(lo, hi + 1, size=n)
    cls = rs.randint(n_classes, size=(n, hi))
    length = rs.uniform(l_lo, l_hi, size=(n, hi))
    start = rs.uniform(0.0, 1.0, size=(n, hi)) * (1.0 - length)
    amp = 4.0 + rs.rand(n, hi)
    gen = torch.Generator(device=device).manual_seed(seeds["noise"])
    feats = torch.randn((n, frames, mels), generator=gen, device=device) * 0.3 - 2.0
    band = max(3, mels // (n_classes + 1))
    f0 = cls * mels // (n_classes + 1)
    t0, t1 = (start * frames).astype(np.int64), ((start + length) * frames).astype(np.int64)
    tt = torch.arange(frames, device=device)
    ff = torch.arange(mels, device=device)
    dev = lambda a: torch.as_tensor(a, device=device)
    for k in range(hi):
        on_t = (tt >= dev(t0[:, k])[:, None]) & (tt < dev(t1[:, k])[:, None])  # [N, T]
        on_f = (ff >= dev(f0[:, k])[:, None]) & (ff < dev(np.minimum(mels, f0[:, k] + band))[:, None])
        gain = dev((amp[:, k] * (k < count)).astype(np.float32))
        feats += gain[:, None, None] * (on_t[:, :, None] & on_f[:, None, :])
    return Clips(feats.cpu().numpy(), cls, start.astype(np.float32), length.astype(np.float32),
                 count)


def event_rows(clips: Clips, i: int, class_names: Sequence[str], seconds: float) -> List:
    """Clip ``i``'s events as the encoder reads them: [label, onset_s, offset_s]."""
    return [[class_names[clips.classes[i, k]], float(clips.start[i, k]) * seconds,
             float(clips.start[i, k] + clips.length[i, k]) * seconds]
            for k in range(clips.count[i])]


def patch_boxes(t: int, num: int, p: Dict, rng: np.random.RandomState) -> np.ndarray:
    """``num`` random (center, length) boxes over ``t`` frames: lengths from
    N(mu, sigma) kept in [lo, hi) (drawn 5 * num at a time), then one integer
    centre frame each, the box snapped to whole frames (SP-SEDT's draw)."""
    lo, hi = p["range"]
    lengths: List[float] = []
    while len(lengths) < num:
        draw = p["mu"] + p["sigma"] * rng.randn(5 * num)
        lengths.extend(v for v in draw if lo <= v < hi)
    boxes = []
    for length in lengths[:num]:
        a, b = int(t * length / 2) + 1, max(int(t * (1 - length / 2)), int(t * length / 2) + 2)
        c = rng.randint(a, b) / t
        s, e = int((c - length / 2) * t), int((c + length / 2) * t)
        boxes.append([(s + e) / (2 * t), (e - s) / t])
    return np.asarray(boxes, dtype=np.float32)


class StrongClips:
    """Strongly labeled clips through the port's dataset protocol; the
    labels are encoded by ``encode`` (the port's ``BoxEncoder``) once a clip,
    as the port's ``DataLoadDf`` memoises them."""

    def __init__(self, clips: Clips, encode, class_names: Sequence[str], seconds: float):
        self.clips, self.encode = clips, encode
        self.class_names, self.seconds = list(class_names), seconds
        self._y: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return len(self.clips.feats)

    def features_only(self, i: int):
        return self.clips.feats[i], self.clips.feats.shape[1]

    def targets_only(self, i: int, t_raw: int) -> Dict:
        if i not in self._y:
            self._y[i] = self.encode(event_rows(self.clips, i, self.class_names, self.seconds))
        return self._y[i]


class PatchClips:
    """Unlabeled clips through the port's dataset protocol: every read of a
    clip's targets draws ``num_patches`` fresh patch boxes from ``rng``,
    encoded as unlabeled by ``encode_unlabel`` (the port's encoder); the
    crops are gathered on the device."""

    def __init__(self, clips: Clips, encode_unlabel, num_patches: int, patch: Dict,
                 rng: np.random.RandomState):
        self.clips, self.encode_unlabel = clips, encode_unlabel
        self.num_patches, self.patch, self.rng = num_patches, patch, rng

    def __len__(self) -> int:
        return len(self.clips.feats)

    def features_only(self, i: int):
        return self.clips.feats[i], self.clips.feats.shape[1]

    def targets_only(self, i: int, t_raw: int) -> Dict:
        y = dict(self.encode_unlabel(patch_boxes(t_raw, self.num_patches, self.patch, self.rng)))
        y.pop("patches", None)
        return y


def check_batches(n: int, traffic: Dict, seeds: Dict[str, int],
                  rng: Optional[np.random.RandomState] = None) -> List[List[int]]:
    """The rows of the steps the reference follows: the first
    ``check_steps`` batches of one permutation (of ``rng``'s next draw when
    given, else of the ``check_order`` seed), so no row repeats."""
    rng = rng if rng is not None else np.random.RandomState(seeds["check_order"])
    order = rng.permutation(n)
    bs = traffic["batch"]
    return [order[i * bs:(i + 1) * bs].tolist() for i in range(traffic["check_steps"])]
