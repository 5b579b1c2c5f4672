#!/usr/bin/env python
"""Inference CLI of the PyTorch port: wav files -> detected-event TSV.

See ``sound_event_detection_transformer_tpu_torch/predict_cli.py`` for the
implementation.  It runs on the current CUDA device and raises without one.

Example:
  python predict_torch.py --checkpoint exp/urbansed/model/best \
    --dataname urbansed --wav_dir ./my_clips --out predictions.tsv --dec_at
"""
from sound_event_detection_transformer_tpu_torch.predict_cli import main

if __name__ == "__main__":
    main()
