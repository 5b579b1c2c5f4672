#!/usr/bin/env python3
"""Benchmark of the PyTorch port: SEDT training throughput on one NVIDIA GPU.

Run from the root of the repository:

    python3 bench_torch.py

The port's counterpart of ``bench.py``, which stays as it is: the flagship
URBAN-SED configuration (SEDT with ResNet-50 DC5, 3+3 pre-norm layers, d 256,
8 heads, FFN 2048, dropout 0.1, ``dec_at``, 10 queries, 20 target slots,
500x64 log-mel clips, batch 64, bf16 autocast over f32 parameters, seeded
weights) through the port's train step: forward, the Hungarian matching on
kernel K1, the set loss, backward, clip and two-group AdamW.  The batch is
``bench.py``'s synthetic one, drawn in the same order from numpy's
``RandomState(0)``, and sits on the card before timing, as ``bench.py``'s
device arrays do.  ``WARMUP`` steps, then ``TRIALS`` runs of ``ITERS`` steps
timed with CUDA events; the median run counts.

Prints exactly one JSON line, with ``bench.py``'s keys:
  {"metric": "sedt_torch_train_clips_per_sec", "value": N,
   "unit": "clips/sec/chip", "vs_baseline": N}

``vs_baseline`` divides by ``bench.py``'s constant of 200 clips/s: an
analytic estimate of the upstream PyTorch trainer on a V100 (see
``bench.py``'s docstring), not a measurement.  The card's name and power
limit go to standard error.  Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.engine import (
    Batch,
    init_train_state,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.models.criterion import empty_targets

ASSUMED_REF_GPU_CLIPS_PER_SEC = 200.0  # bench.py's analytic V100 estimate
BATCH = 64
WARMUP = 3
ITERS = 10
TRIALS = 3
STEPS_PER_EPOCH = 100  # as bench.py: the lr stays at its base over the run


def synthetic_batch(cfg: SEDTConfig, batch: int, device: torch.device | str = "cpu") -> Batch:
    """``bench.py``'s batch: random labels, centres in [0.2, 0.8], lengths in
    [0.05, 0.3], each target slot valid with probability 0.3 (slot 0 always),
    standard-normal features; every clip strong, none padded."""
    m = cfg.model
    rs = np.random.RandomState(0)
    labels = rs.randint(0, m.num_classes, (batch, m.max_events))
    centers = rs.uniform(0.2, 0.8, (batch, m.max_events))
    lengths = rs.uniform(0.05, 0.3, (batch, m.max_events))
    valid = rs.rand(batch, m.max_events) < 0.3
    valid[:, 0] = True
    feats = rs.randn(batch, m.max_frames, m.n_mels, 1)
    valid_t = torch.from_numpy(valid).to(device)
    targets = empty_targets(batch, m.max_events, cfg.features.max_len_seconds, device)._replace(
        labels=torch.from_numpy(labels.astype(np.int32)).to(device),
        boxes=torch.from_numpy(np.stack([centers, lengths], -1).astype(np.float32)).to(device),
        box_valid=valid_t, label_valid=valid_t)
    return Batch(feats=torch.from_numpy(feats.astype(np.float32)).to(device),
                 pad_mask=torch.zeros((batch, m.max_frames), dtype=torch.bool, device=device),
                 targets=targets, strong=torch.ones(batch, dtype=torch.bool, device=device),
                 weak=torch.zeros(batch, dtype=torch.bool, device=device))


def flagship_config(batch: int = BATCH) -> SEDTConfig:
    """``__graft_entry__._flagship_cfg``: the URBAN-SED supervised recipe."""
    cfg = SEDTConfig.urbansed_supervised()
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("bench_torch: no CUDA device; this benchmark needs one GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = flagship_config()
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg, STEPS_PER_EPOCH)
    step = make_train_step(model, wd, cfg, state.optimizer, device=dev)
    batch = synthetic_batch(cfg, BATCH, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(WARMUP):
        metrics = step(batch, gen)
    torch.cuda.synchronize()
    rates = []
    for _ in range(TRIALS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            metrics = step(batch, gen)
        stop.record()
        stop.synchronize()
        rates.append(BATCH * ITERS / (start.elapsed_time(stop) / 1e3))
    if not torch.isfinite(metrics["loss"]).item():
        sys.exit(f"bench_torch: the loss is not finite: {float(metrics['loss'])}")
    clips_per_sec = statistics.median(rates)
    print(f"bench_torch: {card}; runs {[round(r, 2) for r in rates]} clips/s", file=sys.stderr)
    print(json.dumps({
        "metric": "sedt_torch_train_clips_per_sec",
        "value": round(clips_per_sec, 2),
        "unit": "clips/sec/chip",
        "vs_baseline": round(clips_per_sec / ASSUMED_REF_GPU_CLIPS_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
