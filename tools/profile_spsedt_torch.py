#!/usr/bin/env python3
"""Timing of the SP-SEDT self-supervised pretraining step on the PyTorch port.

The port's counterpart of ``tools/profile_spsedt.py``, with its flags,
defaults and geometry: ResNet-50 DC5, 6+6 layers (not the README's pretrain
command's 6+3, so these are not ``chip_smoke.py`` phase 4e's numbers), 20
queries from ``--num_patches`` 10 patches of 128 x 64, feature
reconstruction, 496 x 64 DCASE clips at ``--batch`` 200, bf16 autocast, the
train config's defaults (lr_backbone 1e-4, as the JAX tool's); through the
port's ``make_train_step``, which crops the patches on the device from the
target boxes (``ops/patches.extract_patches_device``: the port has no host
crop) and runs the backbone twice (clips and B x P crops).

It prints ms per step by CUDA events around back-to-back steps and device ms
per step under the profiler (``utils.profiler.busy_ms``), with the card's
name and power limit.

    python3 tools/profile_spsedt_torch.py [--batch 200] [--iters 5] [--num_patches 10]

Runs on ``cuda:0``; without a GPU it raises unless given ``--device cpu``
(host clock only, no device time: the tests' mode).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_step_torch import TrainSetup, train_setup  # noqa: E402
from sound_event_detection_transformer_tpu_torch import config as C  # noqa: E402
from sound_event_detection_transformer_tpu_torch.engine import Batch  # noqa: E402
from sound_event_detection_transformer_tpu_torch.models import resolve_device  # noqa: E402
from sound_event_detection_transformer_tpu_torch.models.criterion import (  # noqa: E402
    empty_targets,
)
from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    Reading,
    card_of,
    measure,
)


def spsedt_config(batch: int = 200, num_patches: int = 10,
                  compute_dtype: str = "bfloat16") -> C.SEDTConfig:
    """The JAX tool's geometry (see the module docstring)."""
    feats = C.FeatureConfig.dcase()
    model = C.ModelConfig(backbone="resnet50", enc_layers=6, dec_layers=6, num_queries=20,
                          num_classes=1, dec_at=False, self_sup=True, feature_recon=True,
                          num_patches=num_patches, max_frames=feats.max_frames,
                          n_mels=feats.n_mels, compute_dtype=compute_dtype)
    return C.SEDTConfig(features=feats, model=model,
                        data=C.DataConfig(classes=("event",), batch_size=batch))


def spsedt_batch(cfg: C.SEDTConfig, device: torch.device, seed: int = 0) -> Batch:
    """The JAX tool's batch, drawn in its order from ``RandomState(seed)``:
    ``num_patches`` patch boxes a clip (centres in [0.1, 0.9], lengths in
    [0.05, 0.3]) as its targets, then standard-normal features."""
    m = cfg.model
    b, p = cfg.data.batch_size, m.num_patches
    rs = np.random.RandomState(seed)
    centers = rs.uniform(0.1, 0.9, (b, p))
    lengths = rs.uniform(0.05, 0.3, (b, p))
    boxes = np.zeros((b, m.max_events, 2), np.float32)
    boxes[:, :p, 0], boxes[:, :p, 1] = centers, lengths
    valid = np.zeros((b, m.max_events), bool)
    valid[:, :p] = True
    valid_t = torch.from_numpy(valid).to(device)
    targets = empty_targets(b, m.max_events, cfg.features.max_len_seconds, device)._replace(
        boxes=torch.from_numpy(boxes).to(device), box_valid=valid_t, label_valid=valid_t)
    feats = torch.from_numpy(rs.randn(b, m.max_frames, m.n_mels, 1).astype(np.float32))
    return Batch(feats=feats.to(device),
                 pad_mask=torch.zeros((b, m.max_frames), dtype=torch.bool, device=device),
                 targets=targets, strong=torch.ones(b, dtype=torch.bool, device=device),
                 weak=torch.zeros(b, dtype=torch.bool, device=device))


def spsedt_setup(cfg: C.SEDTConfig, device: torch.device) -> TrainSetup:
    """The pretraining step (no augmentation) on :func:`spsedt_batch`."""
    return train_setup(cfg, device, spsedt_batch(cfg, device), augment_on=False)


def main(argv=None) -> Reading:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", default=200, type=int)
    ap.add_argument("--iters", default=5, type=int)
    ap.add_argument("--num_patches", default=10, type=int)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda:0")
    card = card_of(dev)
    cfg = spsedt_config(args.batch, args.num_patches, args.compute_dtype)
    r = measure(spsedt_setup(cfg, dev).run, args.iters, dev)
    b, p = args.batch, args.num_patches
    dev_text = ("device not measured" if r.device_ms is None
                else f"device {r.device_ms:.3f} ms ({b / r.device_ms * 1e3:.0f} clips/s)")
    print(f"spsedt pretrain step batch={b} patches={p} E=6 D=6 dtype={args.compute_dtype}: "
          f"{r.ms:.3f} ms ({b / r.ms * 1e3:.0f} clips/s); {dev_text} ({card})")
    return r


if __name__ == "__main__":
    main()
