#!/usr/bin/env python
"""Semi-supervised mean-teacher CLI of the PyTorch port.

The same flags as ``train_ss_sedt.py``: a quarter strong, a quarter weak and
half unlabeled DCASE clips in every batch of ``--semi_batch_size`` (default
64), from the dataset under ``--data_root`` (``metadata/train/`` with
``synthetic_2019/soundscapes.tsv``, ``weak.tsv`` and
``unlabel_in_domain.tsv``) or from generated data (``--synthetic_smoke``).
The student starts from ``--teacher_model``, a checkpoint that
``train_sedt_torch.py`` wrote under ``<exp_root>/dcase/model/`` (its best
model, ``<info>_1_best``); the EMA teacher (``--ema_m``) labels the
unlabeled clips.  Best checkpoints hold the student and the teacher; the
final test uses the teacher unless ``--teacher_eval`` is given.  See
``sound_event_detection_transformer_tpu_torch/train_lib.py`` for the loop.
It runs on the current CUDA device and raises without one.  Installed as
the ``sedt-semi-torch`` console script.

Example (the README's DCASE system, after the supervised stage):
  python train_ss_sedt_torch.py --dataname dcase --data_root build/data \\
    --dec_at --focal_loss --mix_up_ratio 0.6 --freq_mask --freq_shift \\
    --teacher_model <best checkpoint of the supervised stage>
"""
from sound_event_detection_transformer_tpu_torch.cli import main_semi

if __name__ == "__main__":
    main_semi()
