"""The audio-tag cell's traffic: seeded clips of log-mel-like noise with
clip labels, and the batches a closed-loop trainer draws.

A traffic file gives ``batch``, ``labels_per_clip`` [lo, hi], ``zipf`` (the
exponent s of the labels' skew: class c drawn with weight 1 / (c + 1)^s),
``event_length`` [lo, hi] as a share of the clip, ``event_gain`` (dB over
the floor), ``fbank`` (the floor's mean and std, the recipe's dataset
statistics) and ``check_steps``; the configuration gives the clip count,
the frames, the mel bins and the classes.

A clip is a floor of N(mean, std) over [frames, mels] with, for each of its
labels, a band of the clip's mels (class c's at ``c * mels // (C + 1)``,
three bins wide) raised by ``event_gain`` over a random stretch of frames,
then normalised as AST's inputs are, ``(x - mean) / (2 std)``.  The noise
and the bands are made on the device in one pass a label slot; the labels
on the host with numpy.  Every draw comes from a sub-seed of ``--seed``
(:func:`benchmark.traffic.sub_seeds`).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class TagClips(NamedTuple):
    feats: np.ndarray  # [N, T, F] f32 on the host, normalised
    labels: np.ndarray  # [N, C] f32 many-hot


def zipf_weights(n_classes: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n_classes + 1, dtype=np.float64) ** s
    return w / w.sum()


def make_tag_clips(n: int, frames: int, mels: int, n_classes: int, traffic: Dict,
                   seeds: Dict[str, int], device: torch.device) -> TagClips:
    lo, hi = traffic["labels_per_clip"]
    l_lo, l_hi = traffic["event_length"]
    rs = np.random.RandomState(seeds["events"])
    p = zipf_weights(n_classes, traffic["zipf"])
    count = rs.randint(lo, hi + 1, size=n)
    cls = np.zeros((n, hi), np.int64)
    for i in range(n):
        cls[i] = rs.choice(n_classes, size=hi, replace=False, p=p)
    length = rs.uniform(l_lo, l_hi, size=(n, hi))
    start = rs.uniform(0.0, 1.0, size=(n, hi)) * (1.0 - length)
    labels = np.zeros((n, n_classes), np.float32)
    for k in range(hi):
        on = k < count
        labels[np.flatnonzero(on), cls[on, k]] = 1.0
    mean, std = traffic["fbank"]["mean"], traffic["fbank"]["std"]
    gen = torch.Generator(device=device).manual_seed(seeds["noise"])
    feats = torch.randn((n, frames, mels), generator=gen, device=device) * std + mean
    f0 = cls * mels // (n_classes + 1)
    t0, t1 = (start * frames).astype(np.int64), ((start + length) * frames).astype(np.int64)
    tt = torch.arange(frames, device=device)
    ff = torch.arange(mels, device=device)
    dev = lambda a: torch.as_tensor(a, device=device)
    for k in range(hi):
        on_t = (tt >= dev(t0[:, k])[:, None]) & (tt < dev(t1[:, k])[:, None])  # [N, T]
        on_f = (ff >= dev(f0[:, k])[:, None]) & (ff < dev(np.minimum(mels, f0[:, k] + 3))[:, None])
        gain = dev((traffic["event_gain"] * (k < count)).astype(np.float32))
        feats += gain[:, None, None] * (on_t[:, :, None] & on_f[:, None, :])
    feats = (feats - mean) / (2.0 * std)
    return TagClips(feats.cpu().numpy(), labels)


class TagDataset:
    """The clips through the protocol of the port's ``weak_batches``:
    ``dataset[i]`` is (features [T, F], many-hot labels [C])."""

    def __init__(self, clips: TagClips):
        self.clips = clips

    def __len__(self) -> int:
        return len(self.clips.feats)

    def __getitem__(self, i: int):
        return self.clips.feats[i], self.clips.labels[i]


def epoch_batches(n: int, batch: int, rng: np.random.RandomState) -> List[List[int]]:
    """One epoch's full batches of a permutation drawn from ``rng``."""
    order = rng.permutation(n)
    return [order[b * batch:(b + 1) * batch].tolist() for b in range(n // batch)]
