"""The predict cell's traffic: seeded 10 s waveforms held in pageable host
memory, and the batches a bulk predictor cycles over.

A traffic file gives ``batch``, ``clips`` (how many distinct clips are
made; the batches cycle over them), ``events_per_clip`` [lo, hi],
``event_length`` [lo, hi] as a share of the clip, ``amplitude`` [lo, hi],
``noise_std`` and ``tone_hz`` (class c sounds a tone at ``base * 2 **
(c * octaves_per_class)`` and its second harmonic at half the amplitude),
and ``check_steps``.  The configuration gives the sample rate, the clip
length and the classes.

A clip is white noise of ``noise_std`` with, for each of its events, the
class's tone gated on over the event's samples.  The waves are made on the
device in one pass an event slot, then copied once to one pageable numpy
array, which the batches slice without a copy.  Every draw comes from a
sub-seed of ``--seed`` (:func:`benchmark.traffic.sub_seeds`).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch


class Waves(NamedTuple):
    waves: np.ndarray  # [N, S] f32, pageable
    classes: np.ndarray  # [N, K] class ids
    start: np.ndarray  # [N, K] onset, share of the clip
    length: np.ndarray  # [N, K]
    count: np.ndarray  # [N] events of each clip


def make_waves(n: int, sample_rate: int, seconds: float, n_classes: int, traffic: Dict,
               seeds: Dict[str, int], device: torch.device) -> Waves:
    lo, hi = traffic["events_per_clip"]
    l_lo, l_hi = traffic["event_length"]
    a_lo, a_hi = traffic["amplitude"]
    rs = np.random.RandomState(seeds["events"])
    count = rs.randint(lo, hi + 1, size=n)
    cls = rs.randint(n_classes, size=(n, hi))
    length = rs.uniform(l_lo, l_hi, size=(n, hi))
    start = rs.uniform(0.0, 1.0, size=(n, hi)) * (1.0 - length)
    amp = rs.uniform(a_lo, a_hi, size=(n, hi)) * (np.arange(hi)[None] < count[:, None])
    s = int(seconds * sample_rate)
    gen = torch.Generator(device=device).manual_seed(seeds["noise"])
    waves = torch.randn((n, s), generator=gen, device=device) * traffic["noise_std"]
    tone = traffic["tone_hz"]
    hz = tone["base"] * 2.0 ** (cls * tone["octaves_per_class"])
    idx = torch.arange(s, device=device, dtype=torch.float32)
    dev = lambda a: torch.as_tensor(a, device=device)
    s0, s1 = (start * s).astype(np.int64), ((start + length) * s).astype(np.int64)
    for k in range(hi):
        cycles = idx[None] * dev((hz[:, k] / sample_rate).astype(np.float32))[:, None]
        phase = 2.0 * math.pi * torch.frac(cycles)
        on = (idx[None] >= dev(s0[:, k])[:, None]) & (idx[None] < dev(s1[:, k])[:, None])
        sound = torch.sin(phase) + 0.5 * torch.sin(2.0 * phase)
        waves += dev(amp[:, k].astype(np.float32))[:, None] * sound * on
        del cycles, phase, on, sound
    return Waves(waves.cpu().numpy(), cls, start.astype(np.float32), length.astype(np.float32),
                 count)


def batch_rows(k: int, n: int, batch: int) -> slice:
    """The clips of the ``k``-th batch: batches cycle over the ``n`` clips
    (``n`` a multiple of ``batch``)."""
    lo = (k * batch) % n
    return slice(lo, lo + batch)


def names(rows: slice) -> List[str]:
    return [f"clip_{i}.wav" for i in range(rows.start, rows.stop)]
