#!/usr/bin/env python
"""Supervised SEDT training and evaluation CLI of the PyTorch port.

The same flags as ``train_sedt.py``: it trains on a dataset under
``--data_root`` (URBAN-SED or DCASE layout; ``.npy`` log-mels, or raw
waveforms with ``--from_wavs``) or on generated data (``--synthetic_smoke``);
``--pretrain`` waits for SP-SEDT.  See
``sound_event_detection_transformer_tpu_torch/train_lib.py`` for the loop.
It runs on the current CUDA device and raises without one.  Installed as
the ``sedt-train-torch`` console script.

Examples:
  python -m sound_event_detection_transformer_tpu_torch.data.wav_dataset \
    --root build/data --train 16 --validate 8 --test 8
  python train_sedt_torch.py --dataname urbansed --data_root build/data \
    --batch_size 8 --epochs 2 --epochs_ls 1 --dec_at --fusion_strategy 1 2 3 --psds
  python train_sedt_torch.py --dataname urbansed --synthetic_smoke \
    --epochs 3 --epochs_ls 2 --dec_at --fusion_strategy 1 2 3 --psds
"""
from sound_event_detection_transformer_tpu_torch.cli import main_sedt

if __name__ == "__main__":
    main_sedt()
