"""Command-line surface shared by the port's entry points.

Counterpart of ``get_parser`` and ``args_to_config`` of the JAX package's
``train_lib.py``: the same flags, the same defaults and the same dataset
overrides of ``num_queries``, filling the port's own config dataclasses.  The
data assembly and the training loops wait for the trainer slices.
"""
from __future__ import annotations

import argparse
import dataclasses

from . import config as C
from .config import SEDTConfig


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's full flag surface: the same flags with the same
    defaults, so a command line means the same configuration on both sides."""
    p = argparse.ArgumentParser(description="SEDT, PyTorch port")
    # dataset
    p.add_argument("--num_classes", default=10, type=int)
    p.add_argument("--dataname", default="dcase", choices=["urbansed", "dcase"])
    p.add_argument("--synthetic", action="store_true", default=True)
    p.add_argument("--weak", action="store_false", default=True)
    p.add_argument("--synthetic_smoke", action="store_true", default=False,
                   help="run on generated synthetic data (no dataset needed)")
    p.add_argument("--smoke_clips", default=64, type=int)
    p.add_argument("--data_root", default="./data", type=str)
    p.add_argument("--nb_files", default=None, type=int)
    p.add_argument("--max_strong_clips", default=None, type=int,
                   help="cap the strong (synthetic) training split to its "
                        "first N clips; other splits untouched (semi-sup "
                        "label-scarcity controls)")
    # train
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=1e-4, type=float)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--n_weak", default=16, type=int)
    p.add_argument("--accumrating_gradient_steps", default=1, type=int)
    p.add_argument("--adjust_lr", action="store_false", default=True)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--epochs", default=400, type=int)
    p.add_argument("--epochs_ls", default=400, type=int)
    p.add_argument("--checkpoint_epochs", default=0, type=int)
    p.add_argument("--eval_interval", default=1, type=int)
    p.add_argument("--psds", action="store_true", default=False,
                   help="compute PSDS over multiple decode thresholds at the final test")
    p.add_argument("--roc_curves", default=None,
                   help="with --psds: write per-class ROC staircases (CSV + "
                        "PNG) to this path prefix or directory")
    p.add_argument("--lr_drop", default=200, type=int)
    p.add_argument("--fine_tune", action="store_true", default=False)
    p.add_argument("--normalize", action="store_true", default=False)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--seed", default=2020, type=int)
    # augment
    p.add_argument("--mix_up_ratio", type=float, default=0)
    p.add_argument("--time_mask", action="store_true", default=False)
    p.add_argument("--freq_mask", action="store_true", default=False)
    p.add_argument("--freq_shift", action="store_true", default=False)
    # model
    p.add_argument("--self_sup", dest="self_sup", action="store_true")
    p.add_argument("--pretrain", default="")
    p.add_argument("--resume", default="")
    p.add_argument("--dec_at", action="store_true", default=False)
    p.add_argument("--fusion_strategy", default=[1], nargs="+", type=int)
    p.add_argument("--pooling", type=str, default=None,
                   choices=("max", "avg", "attn", "weighted_sum"))
    p.add_argument("--backbone", default="resnet50", type=str)
    p.add_argument("--imagenet_backbone", default=None, type=str,
                   help="torchvision ResNet .pth for ImageNet backbone init; "
                        "defaults to <data_root>/<backbone>.pth when that file "
                        "exists")
    p.add_argument("--dilation", action="store_false", default=True)
    p.add_argument("--position_embedding", default="sine", type=str,
                   choices=("sine", "learned"))
    p.add_argument("--enc_layers", default=3, type=int)
    p.add_argument("--dec_layers", default=3, type=int)
    p.add_argument("--dim_feedforward", default=2048, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_queries", default=20, type=int)
    p.add_argument("--pre_norm", action="store_false", default=True)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="activation/matmul dtype (autocast); params stay float32")
    # SP-SEDT
    p.add_argument("--feature_recon", action="store_true", default=False)
    p.add_argument("--query_shuffle", action="store_true", default=False)
    p.add_argument("--num_patches", default=10, type=int)
    p.add_argument("--fixed_patch_size", action="store_true", default=False)
    p.add_argument("--device_data", dest="device_data", action="store_true",
                   default=True,
                   help="hold the whole dataset's features in device memory and "
                        "gather batches there; on by default in the "
                        "supervised/semi/SP-SEDT trainers when the bank fits")
    p.add_argument("--no_device_data", dest="device_data",
                   action="store_false")
    p.add_argument("--from_wavs", action="store_true", default=False,
                   help="stream raw waveforms to the device and run the "
                        "wav->logmel->normalize frontend inside the train step "
                        "(ops/frontend.make_frontend_fn); the .npy cache is "
                        "still built once for the scaler and the eval splits "
                        "(supervised trainer only)")
    p.add_argument("--shard_bank", action="store_true", default=False,
                   help="force the feature bank to shard over the data-parallel "
                        "devices even when it would fit replicated")
    # loss
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--set_cost_class", default=1, type=float)
    p.add_argument("--set_cost_bbox", default=5, type=float)
    p.add_argument("--set_cost_giou", default=2, type=float)
    p.add_argument("--epsilon", default=1, type=float)
    p.add_argument("--alpha", default=1, type=float)
    p.add_argument("--bbox_loss_coef", default=5, type=float)
    p.add_argument("--giou_loss_coef", default=2, type=float)
    p.add_argument("--eos_coef", default=0.1, type=float)
    p.add_argument("--weak_loss_coef", default=1, type=float)
    p.add_argument("--weak_loss_p_coef", default=1, type=float)
    p.add_argument("--ce_loss_coef", default=1, type=float)
    # semi-supervised
    p.add_argument("--focal_loss", action="store_true", default=False)
    p.add_argument("--ema_decay", default=0.9996, type=float)
    p.add_argument("--accumlating_ema_steps", default=1, type=int)
    p.add_argument("--teacher_model", default="")
    # accepted for drop-in parity with upstream SEDT's command lines; unused
    p.add_argument("--gpus", type=str, default="0",
                   help="(ignored; the port runs on the current CUDA device)")
    p.add_argument("--idim", default=128, type=int, help="(unused, parity)")
    p.add_argument("--input_layer", default="linear", type=str,
                   help="(unused, parity)")
    # misc
    p.add_argument("--info", default=None, type=str)
    p.add_argument("--back_up", action="store_true", default=False)
    p.add_argument("--log", action="store_false", default=True)
    p.add_argument("--exp_root", default="./exp", type=str)
    return p


def args_to_config(args) -> SEDTConfig:
    if args.dataname == "urbansed":
        feats = C.FeatureConfig.urbansed()
        classes = C.URBAN_CLASSES
        max_frames = feats.urban_max_frames
        num_queries = args.num_queries if args.num_queries != 20 else 10
    else:
        feats = C.FeatureConfig.dcase()
        classes = C.DCASE_CLASSES
        max_frames = feats.max_frames
        # dataset override; smoke runs keep the flag
        num_queries = args.num_queries if args.synthetic_smoke else 20
    if args.synthetic_smoke:
        # small geometry for smoke runs
        max_frames = 128
        feats = dataclasses.replace(feats, n_mels=64)
    model = C.ModelConfig(
        backbone=args.backbone,
        dilation=args.dilation,
        position_embedding=args.position_embedding,
        hidden_dim=args.hidden_dim,
        nheads=args.nheads,
        dim_feedforward=args.dim_feedforward,
        enc_layers=args.enc_layers,
        dec_layers=args.dec_layers,
        dropout=args.dropout,
        pre_norm=args.pre_norm,
        num_classes=args.num_classes,
        num_queries=num_queries,
        aux_loss=args.aux_loss,
        dec_at=args.dec_at,
        pooling=args.pooling,
        self_sup=args.self_sup,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        feature_recon=args.feature_recon,
        query_shuffle=args.query_shuffle,
        num_patches=args.num_patches,
        max_frames=max_frames,
        n_mels=feats.n_mels,
    )
    loss = C.LossConfig(
        set_cost_class=args.set_cost_class,
        set_cost_bbox=args.set_cost_bbox,
        set_cost_giou=args.set_cost_giou,
        ce_loss_coef=args.ce_loss_coef,
        bbox_loss_coef=args.bbox_loss_coef,
        giou_loss_coef=args.giou_loss_coef,
        weak_loss_coef=args.weak_loss_coef,
        weak_loss_p_coef=args.weak_loss_p_coef,
        eos_coef=args.eos_coef,
        epsilon=args.epsilon,
        alpha=args.alpha,
    )
    data = C.DataConfig(
        dataset_name=args.dataname,
        root=args.data_root,
        exp_root=args.exp_root,
        classes=classes[: args.num_classes],
        batch_size=args.batch_size,
        n_weak=args.n_weak,
        nb_files=args.nb_files,
        max_strong_clips=getattr(args, "max_strong_clips", None),
    )
    aug = C.AugmentConfig(
        mix_up_ratio=args.mix_up_ratio,
        time_mask=args.time_mask,
        freq_mask=args.freq_mask,
        freq_shift=args.freq_shift,
    )
    train = C.TrainConfig(
        lr=args.lr,
        lr_backbone=args.lr_backbone,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        epochs_ls=args.epochs_ls,
        lr_drop=args.lr_drop,
        adjust_lr=args.adjust_lr,
        clip_max_norm=args.clip_max_norm,
        accumulating_gradient_steps=args.accumrating_gradient_steps,
        accumlating_ema_steps=args.accumlating_ema_steps,
        ema_decay=args.ema_decay,
        seed=args.seed,
        checkpoint_epochs=args.checkpoint_epochs or None,
        eval_interval=getattr(args, 'eval_interval', 1),
        fusion_strategy=tuple(args.fusion_strategy),
        fine_tune=args.fine_tune,
        normalize=args.normalize,
        focal_loss=args.focal_loss,
        info=args.info or f"{args.dataname}_sedt",
    )
    return SEDTConfig(
        features=feats, model=model, loss=loss, data=data, augment=aug, train=train
    )
