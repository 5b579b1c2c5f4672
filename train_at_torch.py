#!/usr/bin/env python
"""Audio-tag backbone trainer CLI of the PyTorch port.

The same flags as ``train_at.py``: clip tagging on URBAN-SED's or DCASE's
training clips under ``--data_root`` (DCASE: the weak and synthetic TSVs,
validated on ``validation.tsv``), or on generated data
(``--synthetic_smoke``), by a ResNet with a pooled MLP head
(``--pooling avg`` unless given, ``--nepochs`` an alias of ``--epochs``),
or with ``--at_model ast`` by AST, the Audio Spectrogram Transformer (its
AudioSet recipe's Adam at ``--lr`` 1e-5 unless given, under bf16 autocast;
``--synthetic_smoke`` clips take its 1024 x 128 x 527 geometry, a dataset
on disk gives it its own), saved as ``at_ast_<dataname>``.
It saves the best checkpoint by validation clip F1 as
``<exp_root>/<dataname>/model/at_<pooling>_<dataname>``, whose backbone
``train_spsedt_torch.py --pretrain at_<pooling>_<dataname>`` loads.  See
``sound_event_detection_transformer_tpu_torch/train_lib.py`` for the loop.
It runs on the current CUDA device and raises without one.  Installed as
the ``sedt-audio-tag-torch`` console script.

Examples (the DCASE chain, on a seeded layout):
  python -m sound_event_detection_transformer_tpu_torch.data.wav_dataset \
    --root build/data --dataname dcase --strong 64 --weak 64 --unlabel 400 \
    --validate 64 --test 64
  python train_at_torch.py --dataname dcase --data_root build/data --pooling avg \
    --epochs 2
  python train_spsedt_torch.py --dataname dcase --data_root build/data \
    --feature_recon --num_patches 10 --num_queries 20 --enc_layers 6 \
    --batch_size 200 --epochs 2 --pretrain at_avg_dcase
  python train_at_torch.py --at_model ast --synthetic_smoke --smoke_clips 128 \
    --batch_size 64 --epochs 2
"""
from sound_event_detection_transformer_tpu_torch.cli import main_at

if __name__ == "__main__":
    main_at()
