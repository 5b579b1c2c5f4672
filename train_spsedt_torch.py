#!/usr/bin/env python
"""SP-SEDT self-supervised pretraining CLI of the PyTorch port.

The same flags as ``train_spsedt.py``: patch-query pretraining on DCASE's
unlabeled clips under ``--data_root`` (``metadata/train/unlabel_in_domain.tsv``,
and with ``--extra_data`` ``dcase2018_task5.tsv``) or on generated data
(``--synthetic_smoke``).  It saves a checkpoint named ``--info`` (default
``pretrain_enc_<n>[_feature_recon][_fixed_patch_size]``) under
``<exp_root>/dcase/model/``, which ``train_sedt_torch.py --pretrain <info>``
loads.  See ``sound_event_detection_transformer_tpu_torch/train_lib.py``
for the loop.  It runs on the current CUDA device and raises without one.
Installed as the ``sedt-pretrain-torch`` console script.

Examples:
  python -m sound_event_detection_transformer_tpu_torch.data.wav_dataset \
    --root build/data --dataname dcase --strong 64 --weak 64 --unlabel 400 \
    --validate 64 --test 64
  python train_spsedt_torch.py --dataname dcase --data_root build/data \
    --feature_recon --num_patches 10 --num_queries 20 --enc_layers 6 \
    --batch_size 200 --epochs 2 --checkpoint_epochs 1
  python train_sedt_torch.py --dataname dcase --data_root build/data --dec_at \
    --pretrain pretrain_enc_6_feature_recon --batch_size 32 --epochs 1 \
    --fusion_strategy 1 2 3
"""
from sound_event_detection_transformer_tpu_torch.cli import main_spsedt

if __name__ == "__main__":
    main_spsedt()
