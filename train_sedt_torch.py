#!/usr/bin/env python
"""Supervised SEDT training and evaluation CLI of the PyTorch port.

The same flags as ``train_sedt.py``; so far it trains on generated data
only (``--synthetic_smoke``).  See
``sound_event_detection_transformer_tpu_torch/train_lib.py`` for the loop.
It runs on the current CUDA device and raises without one.  Installed as
the ``sedt-train-torch`` console script.

Example:
  python train_sedt_torch.py --dataname urbansed --synthetic_smoke \
    --epochs 3 --epochs_ls 2 --dec_at --fusion_strategy 1 2 3 --psds
"""
from sound_event_detection_transformer_tpu_torch.cli import main_sedt

if __name__ == "__main__":
    main_sedt()
