"""Training orchestration shared by the port's entry points.

Counterpart of the JAX package's ``train_lib.py``:

* ``get_parser`` and ``args_to_config``: the same flags, the same defaults
  and the same dataset overrides of ``num_queries``, filling the port's own
  config dataclasses;
* ``build_synthetic_data``: the ``--synthetic_smoke`` datasets;
* ``build_real_data``: the datasets on disk (URBAN-SED or DCASE layout):
  TSVs -> ``SedData`` (the ``.npy`` log-mel cache) -> the scaler of the
  training split -> ``DataLoadDf``, or ``WavLoadDf`` with ``--from_wavs``;
* ``evaluate``: the evaluation step over a dataset, the host decode, the
  event, segment and clip metrics per fusion strategy, and PSDS over decode
  thresholds, returned as an :class:`EvalResult`;
* the four trainers, on one skeleton of plain functions: the set-up
  (``_set_up``), one epoch loop (``_epoch_loop``, under
  ``train_one_epoch`` and ``train_audio_tag_epoch``), the epoch's end
  (``_end_epoch``: one fetch, ``SystemExit(1)`` on a NaN), the timed
  checkpoint write (``_save``), the periodic checkpoint and ``--resume``
  (``_save_periodic``, ``_resume``), and for the supervised and semi
  trainers the validation with its best checkpoints and early stop
  (``_validate``) and the final test (``_final_test``).  Each adds its own
  part:
* ``run_supervised``: the fine-tune stage from ``--epochs_ls``, an ImageNet
  backbone from a torchvision ``.pth``, with ``--from_wavs`` the frontend
  inside the train step, with ``--pretrain`` an SP-SEDT checkpoint carried
  over by ``utils.checkpoint.load_pretrain_into``; a :class:`TrainResult`;
* ``run_spsedt``: SP-SEDT self-supervised pretraining (patch queries on
  unlabeled clips, ``--synthetic_smoke`` or DCASE's
  ``unlabel_in_domain.tsv`` and with ``--extra_data`` its 2018 task 5 TSV;
  the backbone from an audio-tag checkpoint with ``--pretrain``; a final
  checkpoint); a :class:`PretrainResult`;
* ``run_semi``: the mean teacher (strong, weak and unlabeled clips in every
  batch, the clean/noisy view pair, the EMA teacher's pseudo-labels,
  class-wise thresholds adapted each epoch, the teacher's or the student's
  evaluation); a :class:`TrainResult`;
* ``run_audio_tag``: clip tags by a logit-space BCE on ``AudioTagBackbone``
  with clipped Adam, or with ``--at_model ast`` on AST with its recipe's
  Adam under bf16 autocast; the validation's clip macro F1 and a best
  checkpoint, which ``run_spsedt --pretrain`` reads; an
  :class:`AudioTagResult`.

Each trainer runs in a ``torch.distributed`` group of N processes too
(``torchrun``; ``parallel.distribute.init_distributed``): every rank draws
the same global batches and trains on its share of every stream, under
``DistributedDataParallel``, with the criterion's denominators summed over
the ranks (``engine``), so that each step is the JAX package's
data-parallel step on the global batch.  The metrics are reduced once an
epoch; evaluation splits the batches over the ranks and scores them on rank
0; rank 0 decides the best model and early stopping, broadcasts the
decision and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import logging
import math
import os
import os.path as osp
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import config as C
from .config import SEDTConfig
from .data.dataset import (
    ConcatDataset,
    DataLoadDf,
    MultiStreamBatchSampler,
    WavLoadDf,
    batch_iterator,
    ordered_batches,
    weak_batches,
)
from .data.encoder import BoxEncoder, ManyHotEncoder
from .data.feature_bank import maybe_bank
from .data.features import SedData, get_dfs
from .data.scaler import Scaler
from .data.synthetic import SyntheticDataset
from .data.transforms import get_frame_transforms, get_transforms
from .data.tsv import unique
from .engine import (
    adjust_threshold,
    init_train_state,
    make_eval_step,
    make_semi_train_step,
    make_teacher,
    make_train_step,
)
from .metrics import PSDSEval, audio_tagging_results, compute_metrics, format_audio_tagging, psds_score
from .models import AST, AUDIOSET, ASTConfig, AudioTagBackbone, build_model, resolve_device
from .models.resnet import FOLDS, fold_summary
from .models.torch_import import load_imagenet_backbone
from .ops import augment
from .ops.flash_attention import flash_attention
from .ops.frontend import make_frontend_fn
from .parallel.distribute import (
    all_reduce_sum,
    broadcast_object,
    data_rank,
    data_world,
    gather_rows,
    get_reduced_loss,
    get_world_size,
    is_main_process,
    local_rank,
    model_world,
    rank_seed,
)
from .parallel.mesh import local_sizes, share, wrap_model
from .parallel.optim import SEDTOptimizer, make_ast_optimizer, make_audio_tag_optimizer
from .parallel.tensor import same_bits_on_every_rank
from .utils.checkpoint import (
    EarlyStopping,
    SaveBest,
    back_up_code,
    load_audio_tag_backbone,
    load_checkpoint,
    load_pretrain_into,
    save_checkpoint,
)
from .utils.logger import create_logger, set_logger
from .utils.meters import DeviceMetricAccumulator, Heartbeat, MetricLogger
from .utils.profiler import StepTimer, annotate

PSDS_THRESHOLDS = tuple(np.arange(0.1, 1.0, 0.1))  # the final test's decode thresholds


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


# ---------------------------------------------------------------------------
# data assembly
# ---------------------------------------------------------------------------


def _smoke_clips(cfg: SEDTConfig):
    """The ``--synthetic_smoke`` encoder and ``mk(n, seed, **kw)``, a
    :class:`SyntheticDataset` of ``n`` clips at the configuration's geometry."""
    classes = list(cfg.data.classes)
    enc = BoxEncoder(classes, seconds=cfg.features.max_len_seconds)
    return enc, lambda n, seed, **kw: SyntheticDataset(
        n, classes, cfg.model.max_frames, cfg.model.n_mels, enc.encode_strong_df,
        max_events=min(3, cfg.model.max_events), seconds=cfg.features.max_len_seconds,
        seed=seed, **kw)


def build_synthetic_data(cfg: SEDTConfig, args) -> Dict:
    """The ``--synthetic_smoke`` datasets and encoder.  DCASE mode (with
    ``n_weak`` > 0) trains on a strong and a weak stream; validation and
    eval are one set of ``max(8, smoke_clips // 4)`` clips."""
    enc, mk = _smoke_clips(cfg)
    if cfg.data.dataset_name == "dcase" and cfg.data.n_weak > 0 and not cfg.model.self_sup:
        train = ConcatDataset([mk(args.smoke_clips, 0),
                               mk(max(cfg.data.n_weak * 2, 4), 2, weak_only=True)])
    else:
        train = mk(args.smoke_clips, 0)
    valid = mk(max(8, args.smoke_clips // 4), 1)
    return {"train": train, "validation": valid, "eval": valid, "encoder": enc,
            "ref_valid": valid.ref_rows(), "ref_eval": valid.ref_rows()}


def cap_strong_clips(rows: List[Dict], n: int) -> List[Dict]:
    """The rows of the first ``n`` distinct clips, in the TSV's order: the
    label-scarcity knob ``--max_strong_clips``, which caps only the strong
    (synthetic) training split, where ``nb_files`` cuts every split."""
    keep = set(unique(r["filename"] for r in rows)[:n])
    return [r for r in rows if r["filename"] in keep]


def real_data_paths(cfg: SEDTConfig) -> Tuple[Dict[str, str], Optional[Dict[str, str]]]:
    """(TSV per split, audio directory per split where the metadata -> audio
    mapping does not hold) of the dataset under ``<root>/<dataset>``."""
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    meta = lambda *p: osp.join(root, "metadata", *p)
    if cfg.data.dataset_name == "urbansed":
        return {"train": meta("train.tsv"), "validation": meta("validate.tsv"),
                "eval": meta("test.tsv")}, None
    # DCASE's validation audio lies at audio/validation, one level above the
    # TSV's mapping
    return ({"weak": meta("train", "weak.tsv"),
             "synthetic": meta("train", "synthetic_2019", "soundscapes.tsv"),
             "validation": meta("validation", "validation.tsv"),
             "eval": meta("eval", "public.tsv")},
            {"validation": osp.join(root, "audio", "validation")})


def ref_rows(rows: List[Dict]) -> List[Tuple]:
    """A split's ground truth for the metrics: ``(filename, onset, offset,
    event_label)`` per row; a clip without events is one row labelled None."""
    return [(r["filename"], r["onset"], r["offset"], r["event_label"]) for r in rows]


def _sed_data(cfg: SEDTConfig) -> Tuple[str, SedData]:
    """``<data_root>/<dataset>`` and its ``SedData``, which extracts missing
    ``.npy`` mel amplitudes without the dB (the transform's, per clip)."""
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    return root, SedData(cfg.data.dataset_name, base_feature_dir=osp.join(root, "features"),
                         compute_log=False)


def _fit_scaler(path: str, make_pre, timings: Dict) -> Scaler:
    """The scaler saved at ``path``, else one computed over the dataset
    ``make_pre()`` and saved there; its seconds into ``timings``."""
    scaler = Scaler()
    t0 = time.perf_counter()
    if osp.isfile(path):
        scaler.load(path)
    else:
        pre = make_pre()
        scaler.calculate_scaler(pre.features_only(i)[0] for i in range(len(pre)))
        os.makedirs(osp.dirname(path), exist_ok=True)
        scaler.save(path)
    timings["scaler_s"] = time.perf_counter() - t0
    return scaler


def build_real_data(cfg: SEDTConfig, args) -> Dict:
    """The datasets on disk under ``<data_root>/<dataset>``.

    Each split's TSV goes through ``SedData`` (:func:`_sed_data`).  The
    scaler is computed over the training split (DCASE: weak then synthetic)
    and saved at ``<exp_root>/<dataset>.json``, or loaded from there when
    that file exists.  Training reads ``.npy`` features through
    dB -> pad -> normalize, or with ``--from_wavs`` raw waveforms
    (``WavLoadDf``; the returned ``frontend`` arguments build the step's
    frontend from the same scaler); validation and eval always read
    ``.npy``.  ``timings`` holds the seconds of the feature pass and of the
    scaler, and the clips extracted.
    """
    _, ds = _sed_data(cfg)
    paths, audio_dirs = real_data_paths(cfg)
    t0 = time.perf_counter()
    dfs = get_dfs(ds, paths, nb_files=cfg.data.nb_files, audio_dirs=audio_dirs)
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": sum(len(unique(r["filename"] for r in rows)) for rows in dfs.values())}
    if cfg.data.max_strong_clips and "synthetic" in dfs:
        dfs["synthetic"] = cap_strong_clips(dfs["synthetic"], cfg.data.max_strong_clips)
    enc = BoxEncoder(list(cfg.data.classes), seconds=cfg.features.max_len_seconds)

    base_tf = get_transforms(cfg.model.max_frames, None, compute_log=True)
    scaler = _fit_scaler(
        osp.join(cfg.data.exp_root, cfg.data.dataset_name + ".json"),
        lambda: ConcatDataset([DataLoadDf(dfs[s], transform=base_tf) for s in (
            ["train"] if "train" in dfs else ["weak", "synthetic"])]), timings)

    tf = get_transforms(cfg.model.max_frames, scaler, compute_log=True)
    cache = cfg.data.in_memory
    out = {"encoder": enc, "scaler": scaler, "timings": timings}
    if getattr(args, "from_wavs", False):
        fc = ds.fc
        mk_train = lambda rows: WavLoadDf(
            rows, enc.encode_strong_df, n_samples=int(cfg.features.max_len_seconds * fc.sample_rate),
            sr=fc.sample_rate, in_memory=cache)
        out["frontend"] = dict(sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window,
                               hop=fc.hop_size, n_mels=fc.n_mels, scaler_mean=scaler.mean_,
                               scaler_std=scaler.std_)
    else:
        mk_train = lambda rows: DataLoadDf(rows, enc.encode_strong_df, tf, in_memory=cache,
                                           cache_transformed=cache)
    out["train"] = (mk_train(dfs["train"]) if "train" in dfs
                    else ConcatDataset([mk_train(dfs["synthetic"]), mk_train(dfs["weak"])]))
    for split in ("validation", "eval"):
        out[split] = DataLoadDf(dfs[split], enc.encode_strong_df, tf, cache_transformed=cache)
    out["ref_valid"], out["ref_eval"] = ref_rows(dfs["validation"]), ref_rows(dfs["eval"])
    return out


# ---------------------------------------------------------------------------
# evaluation loop
# ---------------------------------------------------------------------------


class EvalResult(NamedTuple):
    """What :func:`evaluate` measured."""

    f1: Dict[int, float]  # event-based F1 per fusion strategy
    loss_means: Dict[str, float]  # the step's loss means (with ``weight_dict``)
    psds: Dict[int, Tuple[float, float, float]]  # per strategy (with ``psds_thresholds``)
    timings: Dict[str, float]  # seconds of eval steps, decode, metrics, PSDS; batches


def evaluate(
    eval_step,
    dataset,
    cfg: SEDTConfig,
    decoder: BoxEncoder,
    ref_rows,
    fusion_strategy: Sequence[int],
    at: bool = True,
    cal_seg: bool = False,
    cal_clip: bool = False,
    batch_size: Optional[int] = None,
    psds_thresholds: Optional[Sequence[float]] = None,
    weight_dict: Optional[Dict[str, float]] = None,
    bank=None,
    roc_curves: Optional[str] = None,
) -> EvalResult:
    """The evaluation step over ``dataset``, the host decode at threshold
    0.5 and the metrics against ``ref_rows``, with the event-based F1 of each
    fusion strategy.

    The last batch is filled up with −1 rows, which the step's loss masks
    and the decode skip.  With ``weight_dict`` the step's losses are summed
    on the device, each batch weighted by its real rows, and logged as "Val
    averaged stats" (and returned), so the means do not depend on the batch
    size.  With ``psds_thresholds``, PSDS over those decode thresholds per
    strategy (the ROC curves to ``roc_curves``).  The timings are the seconds
    of the eval steps (with the wait for the batches and the copy of the
    results to the host), of the host decode, of the metrics and of PSDS.

    In a process group each rank evaluates a contiguous 1/N of the ordered
    batches (the last ranks' lists filled up with all-pad batches, so that
    a sharded bank's gathers stay in step), the loss sums are reduced over
    the ranks, the decoded rows are gathered on rank 0, which computes the
    metrics and PSDS, and the result is broadcast: every rank returns what
    one process would.
    """
    log = create_logger(__name__ + "/evaluate")
    bs = batch_size or cfg.data.batch_size
    seconds = cfg.features.max_len_seconds
    pin = eval_step.device.type == "cuda"
    loss_acc = DeviceMetricAccumulator() if weight_dict is not None else None
    at_rows: List = []
    dec_rows: Dict[int, List] = {m: [] for m in fusion_strategy}
    raw: Dict[int, List] = {m: [] for m in fusion_strategy}  # for PSDS's operating points
    filenames = dataset.filenames
    clip = lambda t: float(np.clip(t, 0, seconds))
    t_steps = t_decode = 0.0
    n_batches = 0
    world = data_world()
    batches = ordered_batches(len(dataset), bs)
    per_rank = -(-len(batches) // world)
    batches += [[-1] * bs] * (per_rank * world - len(batches))
    # round j holds every rank's j-th batch: rank r's share is batches[r * per_rank + j]
    rounds = [[i for r in range(world) for i in batches[r * per_rank + j]]
              for j in range(per_rank)]
    mark = time.perf_counter()
    for batch in batch_iterator(dataset, rounds, cfg.model.max_events, seconds,
                                return_indexes=True, bank=bank, pin_memory=pin):
        idxs = batch.indexes.numpy()
        if bank is not None:  # the global round's indexes: this rank's share
            idxs = share(idxs)
        valid = torch.from_numpy(idxs >= 0)
        if bank is not None:
            batch = batch._replace(feats=bank.gather(batch.indexes))
        res = eval_step(batch, valid.pin_memory() if pin else valid)
        if loss_acc is not None:
            loss_acc.update(res["losses"], weight=float(valid.sum()))
        tags = res["at"].cpu().numpy() > 0.5 if at and "at" in res else None
        # one copy per strategy: scores, labels and boxes side by side
        fetched = {m: torch.cat([res[f"pp_{m}"].scores.float()[..., None],
                                 res[f"pp_{m}"].labels.float()[..., None],
                                 res[f"pp_{m}"].boxes.float()], -1).cpu().numpy()
                   for m in fusion_strategy}
        now = time.perf_counter()
        t_steps += now - mark
        n_batches += 1
        if tags is not None:
            for j, row in enumerate(tags):
                if idxs[j] >= 0:
                    at_rows.extend((filenames[idxs[j]], 0.0, 0.0, lbl)
                                   for lbl in decoder.decode_weak(row.astype(int)))
        for m in fusion_strategy:
            out = fetched[m]
            scores, labels, boxes = out[..., 0], out[..., 1].astype(np.int64), out[..., 2:]
            if psds_thresholds is not None:
                raw[m].append((scores, labels, boxes, idxs))
            for j, pred in decoder.decode_strong_batch(scores, labels, boxes,
                                                       threshold=0.5).items():
                if idxs[j] >= 0:
                    dec_rows[m].extend((filenames[idxs[j]], clip(on), clip(off), lbl, float(sc))
                                       for lbl, on, off, sc in pred)
        mark = time.perf_counter()
        t_decode += mark - now
    log.info(f"eval steps {t_steps:.3f}s, host decode {t_decode:.3f}s ({n_batches} batches)")

    means: Dict[str, float] = {}
    if loss_acc is not None and loss_acc.steps:
        means, _ = loss_acc.means()
        vlog = MetricLogger(delimiter="  ")
        get_reduced_loss(means, weight_dict, vlog)
        log.info("Val averaged stats:\n" + str(vlog))
    gathered = gather_rows([(at_rows, dec_rows, raw)])

    def score():
        at_all = [r for part in gathered for r in part[0]]
        dec_all = {m: [r for part in gathered for r in part[1][m]] for m in fusion_strategy}
        raw_all = {m: [r for part in gathered for r in part[2][m]] for m in fusion_strategy}
        return _score(at_all, dec_all, raw_all, log, filenames, decoder, ref_rows,
                      fusion_strategy, at, cal_seg, cal_clip, psds_thresholds, roc_curves,
                      seconds)

    metrics, psds_values, t_metrics, t_psds = _on_main(score)
    return EvalResult(metrics, means, psds_values,
                      dict(eval_steps_s=t_steps, decode_s=t_decode, metrics_s=t_metrics,
                           psds_s=t_psds, batches=n_batches))


def _on_main(fn):
    """``fn()`` on rank 0, its result broadcast to every rank (``fn()`` itself
    for one process): rank 0 decides."""
    return broadcast_object(fn() if is_main_process() else None)


def _score(at_rows, dec_rows, raw, log, filenames, decoder, ref_rows, fusion_strategy, at,
           cal_seg, cal_clip, psds_thresholds, roc_curves, seconds):
    """:func:`evaluate`'s metrics of the decoded rows: (F1 per strategy, PSDS
    per strategy, seconds of the metrics, seconds of PSDS)."""
    clip = lambda t: float(np.clip(t, 0, seconds))
    t0 = time.perf_counter()
    if at and at_rows:
        log.info(f"AT class-wise clip metrics\n{'=' * 50}\n"
                 f"{format_audio_tagging(audio_tagging_results(ref_rows, at_rows))}")
    metrics, psds_values = {}, {}
    t_psds = 0.0
    for m in fusion_strategy:
        log.info(f"Fusion strategy: {m} ({len(dec_rows[m])} events)")
        metrics[m] = compute_metrics(dec_rows[m], ref_rows, cal_seg=cal_seg, cal_clip=cal_clip)
        if psds_thresholds is not None:
            t1 = time.perf_counter()
            meta = [(f, seconds) for f in dict.fromkeys(r[0] for r in ref_rows)]
            psds = PSDSEval(ground_truth=ref_rows, metadata=meta)
            for thr in psds_thresholds:
                rows = []
                for scores, labels, boxes, idxs in raw[m]:
                    for j, pred in decoder.decode_strong_batch(scores, labels, boxes,
                                                               threshold=thr).items():
                        if idxs[j] >= 0:
                            rows.extend((filenames[idxs[j]], clip(on), clip(off), lbl)
                                        for lbl, on, off, _ in pred)
                psds.add_operating_point(rows)
            log.info(f"PSDS over {len(psds_thresholds)} operating points:")
            psds_values[m] = psds_score(psds, filename_roc_curves=roc_curves)
            t_psds += time.perf_counter() - t1
    t_metrics = time.perf_counter() - t0 - t_psds
    log.info(f"metrics {t_metrics:.3f}s, PSDS {t_psds:.3f}s")
    return metrics, psds_values, t_metrics, t_psds


# ---------------------------------------------------------------------------
# supervised training driver
# ---------------------------------------------------------------------------


class TrainResult(NamedTuple):
    """What :func:`run_supervised` or :func:`run_semi` measured."""

    f1: Dict[int, float]  # the final test's F1 on eval, last strategy (as the JAX package)
    # per epoch: train loss means, lr, steps, seconds and the wait for
    # batches; with an evaluation its loss means, F1 and timings; the
    # checkpoint seconds; ``run_semi``'s also the pseudo events per class
    # and the thresholds adapted from them for the next epoch
    epochs: List[Dict]
    final: List[Dict]  # per strategy of the final test: F1, PSDS or the model tested, timings
    bank: bool  # whether the feature bank held the features
    model_dir: str
    # on disk: seconds of the feature pass and the scaler, clips extracted
    data_timings: Dict


def init_model(cfg: SEDTConfig, device: torch.device):
    """The model to train and its loss weights: parameters drawn on the CPU
    from ``cfg.train.seed``, then moved to ``device``."""
    return build_model(cfg, device=device,
                       generator=torch.Generator().manual_seed(cfg.train.seed))


def _imagenet_backbone_init(model, args, log) -> Optional[str]:
    """Load the torchvision checkpoint ``--imagenet_backbone``, else
    ``<data_root>/<backbone>.pth`` when that file exists, into
    ``model.backbone``, or warn that the backbone trains from scratch;
    returns the path loaded."""
    path = getattr(args, "imagenet_backbone", None)
    if not path:
        auto = osp.join(args.data_root, f"{args.backbone}.pth")
        path = auto if osp.isfile(auto) else None
    if not path:
        log.warning(
            "backbone trains FROM SCRATCH — no ImageNet checkpoint found; pass "
            f"--imagenet_backbone <torchvision .pth> (or put {args.backbone}.pth into "
            f"{args.data_root}) for the pretrained initialization")
        return None
    report = load_imagenet_backbone(model.backbone, path, log=log)
    log.info(f"initialized backbone from ImageNet weights: {path} ({len(report.loaded)} "
             f"leaves, {len(report.skipped)} skipped)")
    return path


def trainer_device(device: Optional[torch.device | str]) -> torch.device:
    """A trainer's device: ``device`` if given; in a process group of several
    ranks ``cuda:LOCAL_RANK``, which must exist (no two ranks share a card
    unless the caller says so); else the current CUDA device."""
    if device is None and get_world_size() > 1:
        device = torch.device("cuda", local_rank())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def _set_up(args, device, cfg: SEDTConfig, stream_sizes: Sequence[int], name: str,
            title: str) -> Tuple[torch.device, logging.Logger, str]:
    """A trainer's start: (its device, its logger ``name``, its model dir,
    made), with ``--log``'s file.  First it raises for a layout the trainers
    do not run: a model axis (the JAX trainers' ``MeshConfig()``; the dryrun
    reaches it), or ``stream_sizes`` that do not divide over the ranks."""
    dev = trainer_device(device)
    if model_world() > 1:
        raise ValueError("the trainers run every rank on the data axis: a layout with "
                         f"{model_world()} model ranks is the dryrun's")
    local_sizes(stream_sizes, get_world_size())
    if args.log:
        set_logger(cfg.train.info)
    log = create_logger(name)
    log.info(title)
    model_dir = osp.join(cfg.data.exp_root, cfg.data.dataset_name, "model")
    os.makedirs(model_dir, exist_ok=True)
    return dev, log, model_dir


def _policies(cfg: SEDTConfig) -> Tuple[Dict[int, SaveBest], EarlyStopping]:
    """Rank 0's policies: a best model per fusion strategy, the early stop."""
    return ({m: SaveBest("sup") for m in cfg.train.fusion_strategy},
            EarlyStopping(patience=cfg.train.early_stopping_patience,
                          init_patience=cfg.train.early_stopping_init_wait,
                          fusion_strategy=cfg.train.fusion_strategy))


def _save_periodic(record: Dict, cfg: SEDTConfig, prefix: str, epoch: int, model,
                   optimizer: SEDTOptimizer, gen: torch.Generator,
                   streams: Dict[str, np.random.RandomState], policies=None, **extra) -> None:
    """Every ``checkpoint_epochs`` epochs the checkpoint ``{prefix}_{epoch}``
    (:func:`_save`), which :func:`_resume` reads: the model, the optimizer,
    the epoch, each numpy stream under its key, rank 0's step generator
    (``generator``) and in a group every rank's (``generators``, a
    collective), the policies' states if given, then ``extra``."""
    if not cfg.train.checkpoint_epochs or (epoch + 1) % cfg.train.checkpoint_epochs:
        return
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(), "epoch": epoch}
    for key, rng in streams.items():
        _, keys, pos, has_gauss, cached = rng.get_state()
        state[key] = {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
                      "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}
    state["generator"] = gen.get_state()
    if data_world() > 1:
        state["generators"] = gather_rows([gen.get_state()])
    if policies is not None:
        state.update(save_best={m: s.state_dict() for m, s in policies[0].items()},
                     early=policies[1].state_dict())
    _save(record, f"{prefix}_{epoch}", {**state, **extra})


def _resume(ck: Dict, name: str, log, model, optimizer: SEDTOptimizer, gen: torch.Generator,
            streams: Dict[str, np.random.RandomState], policies=None) -> int:
    """``--resume name`` from its checkpoint ``ck``: the model, and from a
    periodic checkpoint (:func:`_save_periodic`, of a run of the same
    world size) the rest; returns the epoch to go on at."""
    model.load_state_dict(ck["model"])
    if "optimizer" in ck:
        optimizer.load_state_dict(ck["optimizer"])
        for key, rng in streams.items():
            st = ck[key]
            rng.set_state(("MT19937", st["keys"].numpy().astype(np.uint32), st["pos"],
                           st["has_gauss"], st["cached_gaussian"]))
        states = ck.get("generators", [ck["generator"]])
        if len(states) != data_world():
            raise ValueError(f"--resume: the checkpoint holds {len(states)} rank(s)' "
                             f"generators, this run has {data_world()}")
        gen.set_state(states[data_rank()])
        if policies is not None:
            for m, sd in ck["save_best"].items():
                policies[0][m].load_state_dict(sd)
            policies[1].load_state_dict(ck["early"])
    start_epoch = int(ck.get("epoch", -1)) + 1
    log.info(f"resumed from {name}: epoch {start_epoch} next")
    return start_epoch


def _save(record: Dict, path: str, content: Dict) -> None:
    """The checkpoint ``content`` written at ``path``, its seconds added to
    ``record["checkpoint_s"]``."""
    t = time.perf_counter()
    save_checkpoint(path, content)
    record["checkpoint_s"] = record.get("checkpoint_s", 0.0) + time.perf_counter() - t


def _epoch_loop(batches: Iterator, total: int, step, gather, log):
    """The epoch loop: ``step(batch)`` (metrics with ``loss``) on each of the
    ``total`` batches, after ``gather(batch)`` unless None.  Spans:
    ``train.epoch``, and each batch's ``train.wait``, ``train.gather``,
    ``train.step``."""
    acc = DeviceMetricAccumulator(partials=True)
    timer = StepTimer()
    hb = Heartbeat(log.info, total)
    with annotate("train.epoch"):
        for i in itertools.count():
            # the wait runs from the last step's end to the next batch's
            # arrival: the first starts the prefetch thread, and each one
            # frees the batch before it (the prefetcher drops its last
            # reference in ``next``), whose pinned memory records CUDA
            # events on release, which can block while the device is behind
            try:
                with annotate("train.wait") as wait:
                    batch = next(batches)
            except StopIteration:  # the ended wait, for no batch, is not counted
                break
            timer.data_loaded(wait.seconds)
            if gather is not None:
                with annotate("train.gather"):
                    batch = gather(batch)
            with annotate("train.step"):
                m = step(batch)
            acc.update(m)  # summed on the device; no host sync
            hb.tick(i)
            # a finiteness probe every 500 steps bounds the compute lost to a
            # NaN (of the global loss, so every rank stops at the same step);
            # the epoch-end check is the backstop
            if (i + 1) % 500 == 0 and not math.isfinite(float(all_reduce_sum(m["loss"]))):
                log.info("Loss is not finite (mid-epoch probe), stopping")
                raise SystemExit(1)
            timer.step_done()  # the next wait starts here
    return acc, timer


def train_one_epoch(train_step, dataset, sampler, cfg: SEDTConfig, bank, generator, log):
    """One pass of ``sampler`` (global index lists; a
    :class:`MultiStreamBatchSampler`'s ``batch_sizes`` are its streams) over
    ``dataset`` through ``train_step``, on this rank's share of each batch;
    returns the metrics summed on the device (a
    :class:`DeviceMetricAccumulator` of partials, not yet fetched) and the
    step timer (:func:`_epoch_loop`).  Batches are pinned for the card, and
    with ``bank`` their features are gathered there."""
    batches = batch_iterator(dataset, iter(sampler), cfg.model.max_events,
                             cfg.features.max_len_seconds, bank=bank,
                             pin_memory=train_step.device.type == "cuda",
                             stream_sizes=getattr(sampler, "batch_sizes", None))
    gather = (None if bank is None
              else lambda b: b._replace(feats=bank.gather(b.indexes), indexes=None))
    return _epoch_loop(batches, len(sampler), lambda b: train_step(b, generator), gather, log)


def _end_epoch(log, record: Dict, sums: Dict, steps: int, timer: StepTimer, t0: float,
               folds0: Dict, note: str = "") -> Dict:
    """An epoch's end after the one fetch of its ``sums``: the line ``Epoch
    N: loss ...`` (then ``note``), the loss mean, steps, seconds since
    ``t0`` and wait for batches into ``record``, and ``SystemExit(1)`` on a
    non-finite loss mean.  Returns the means over the steps."""
    train_s = time.time() - t0
    means = {k: v / max(steps, 1) for k, v in sums.items()}
    loss = float(means.get("loss", float("nan")))
    log.info(f"Epoch {record['epoch']}: loss {loss:.4f} ({steps} steps, {train_s:.1f}s) "
             f"{timer.summary()}; {fold_summary(folds0)}{note}")
    record.update(loss=loss, steps=steps, train_s=train_s, data_wait_s=timer.data_time.sum)
    if not math.isfinite(loss):
        log.info(f"Loss is {loss}, stopping training")
        raise SystemExit(1)
    return means


def _log_stats(log, means: Dict, weights: Dict[str, float], **logged) -> None:
    """The line "Train averaged stats": each mean but the loss and
    ``logged``'s, unscaled and scaled by ``weights``, then those."""
    mlog = MetricLogger(delimiter="  ")
    get_reduced_loss({k: v for k, v in means.items() if k != "loss" and k not in logged},
                     weights, mlog)
    mlog.update(loss=means["loss"], **logged)
    mlog.synchronize_between_processes()
    log.info("Train averaged stats:\n" + str(mlog))


def supervised_streams(cfg: SEDTConfig) -> List[int]:
    """The supervised trainer's batch layout: strong | weak rows on DCASE
    with ``n_weak`` > 0 (the dataset has both streams), else one stream."""
    bs, n_weak = cfg.data.batch_size, cfg.data.n_weak
    if cfg.data.dataset_name == "dcase" and n_weak > 0 and not cfg.model.self_sup:
        return [bs - n_weak, n_weak]
    return [bs]


def _validate(log, heading: str, eval_step, cfg: SEDTConfig, data: Dict, bank, weight_dict,
              policies, record: Dict, best: str, content: Dict) -> Tuple[Dict[int, float], bool]:
    """An epoch's validation into ``record``; per fusion strategy ``m`` rank
    0's policies decide a new best, written as ``{best}_{m}_best``
    (``content`` and the F1: a best checkpoint is read for its model only),
    and the early stop.  Returns (F1 per strategy, whether to stop)."""
    log.info(heading)
    res = evaluate(eval_step, data["validation"], cfg, data["encoder"], data["ref_valid"],
                   cfg.train.fusion_strategy, at=cfg.model.dec_at, weight_dict=weight_dict,
                   bank=bank)
    record.update(val_loss_means=res.loss_means, val_f1=dict(res.f1), eval_timings=res.timings)
    decisions = _on_main(lambda: [(policies[0][m].apply(f1), policies[1].apply(f1))
                                  for m, f1 in res.f1.items()])
    for (m, f1), (new_best, stop) in zip(res.f1.items(), decisions):
        if new_best:
            _save(record, f"{best}_{m}_best", {**content, f"event_based_f1_{m}": f1})
        if stop:
            log.warning("EARLY STOPPING")
    return res.f1, any(stop for _, stop in decisions)


def _final_test(log, cfg: SEDTConfig, data: Dict, banks: Tuple, best: str, restore, step,
                psds_thresholds=None, roc_curves=None) -> Tuple[Dict[int, float], List[Dict]]:
    """The final test on validation and eval per fusion strategy ``m``, of
    ``{best}_{m}_best`` where it exists (``restore(ck)`` returns its step),
    else of the step tested last, ``step`` at first.  Returns (the last
    strategy's eval F1, as the JAX package's; a record per strategy)."""
    metrics, final = {}, []
    for m in cfg.train.fusion_strategy:
        record = {"fusion_strategy": m}
        final.append(record)
        path = f"{best}_{m}_best"
        if osp.exists(path):
            t = time.perf_counter()
            step = restore(load_checkpoint(path))
            record.update(checkpoint_s=time.perf_counter() - t, loaded=path)
        log.info("Metric on validation")
        res = evaluate(step, data["validation"], cfg, data["encoder"], data["ref_valid"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True, bank=banks[0])
        record.update(valid_f1=res.f1[m], valid_timings=res.timings)
        log.info("Metric on eval")
        res = evaluate(step, data["eval"], cfg, data["encoder"], data["ref_eval"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True,
                       psds_thresholds=psds_thresholds, bank=banks[1], roc_curves=roc_curves)
        metrics = res.f1
        record.update(eval_f1=metrics[m], eval_timings=res.timings, psds=res.psds)
    return metrics, final

def run_supervised(args, device: Optional[torch.device | str] = None) -> TrainResult:
    """The supervised trainer, on ``--synthetic_smoke`` data or on the
    dataset under ``--data_root``, with the final test's event-based F1 on
    the eval set (of the last fusion strategy, as the JAX package does) and
    what the run measured.

    Runs on ``device`` (the GPU when None).  The backbone starts from an
    ImageNet checkpoint when one is named or present.  Per epoch: the train
    steps (with ``--from_wavs`` on raw waveforms, featurised inside the step,
    and without a feature bank: the host streams the audio); every
    ``eval_interval`` epochs the validation; from epoch ``epochs_ls`` on, the
    fine-tune stage.  Then the final test (PSDS with ``--psds``).
    """
    cfg = args_to_config(args)
    batch_sizes = supervised_streams(cfg)
    dev, log, model_dir = _set_up(args, device, cfg, batch_sizes, "train_sedt_torch",
                                  "Sound Event Detection Transformer (PyTorch)")
    np.random.seed(cfg.train.seed)
    epochs: List[Dict] = []

    data = build_synthetic_data(cfg, args) if args.synthetic_smoke else build_real_data(cfg, args)
    if args.back_up:
        back_up_code(osp.dirname(model_dir), cfg.train.info)

    concat = (data["train"] if isinstance(data["train"], ConcatDataset)
              else ConcatDataset([data["train"]]))
    sampler = MultiStreamBatchSampler(concat, batch_sizes, seed=cfg.train.seed)
    steps_per_epoch = max(len(sampler), 1)

    model, weight_dict = init_model(cfg, dev)
    _imagenet_backbone_init(model, args, log)
    state = init_train_state(model, cfg, steps_per_epoch)
    log.info(f"number of parameters in the model: {sum(p.numel() for p in model.parameters())}")
    if args.pretrain:  # after the ImageNet init, before --resume
        loaded = load_pretrain_into(
            model, load_checkpoint(osp.join(model_dir, args.pretrain))["model"])
        log.info(f"loaded self-supervised pretrain weights from {args.pretrain}: "
                 f"{len(loaded)} parameters")
    gen = torch.Generator(device=dev).manual_seed(rank_seed(cfg.train.seed))
    policies = _policies(cfg)
    info = cfg.train.info
    fine_tune = cfg.train.fine_tune

    def fine_tune_stage():
        nonlocal state, fine_tune, info
        state = init_train_state(model, cfg, steps_per_epoch, fixed_lr=1e-5)
        fine_tune = True
        info = cfg.train.info + "_ft"

    start_epoch = 0
    if args.resume:
        ck = load_checkpoint(osp.join(model_dir, args.resume))
        if int(ck.get("epoch", -1)) >= args.epochs_ls:  # written in the fine-tune stage
            fine_tune_stage()
        start_epoch = _resume(ck, args.resume, log, model, state.optimizer, gen,
                              {"sampler": sampler.rng}, policies)

    frontend_fn = None
    if data.get("frontend") is not None:  # --from_wavs
        frontend_fn = make_frontend_fn(max_frames=cfg.model.max_frames, compute_log=True,
                                       **data["frontend"])
        log.info("waveform frontend inside the train step (--from_wavs)")

    net = wrap_model(model, dev)  # after the freeze; the checkpoints save `model`

    def make_step():
        return make_train_step(net, weight_dict, cfg, state.optimizer, fine_tune=fine_tune,
                               normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                               frontend_fn=frontend_fn, device=dev)

    def restore(ck):
        model.load_state_dict(ck["model"])
        return eval_step

    train_step = make_step()
    eval_step = make_eval_step(model, weight_dict, cfg, cfg.train.fusion_strategy, device=dev)
    # --from_wavs measures the streaming path: the host ships the audio of
    # every step, so its waveforms are not banked
    train_bank = None if frontend_fn is not None else maybe_bank(args, concat, cfg, dev, log=log)
    valid_bank = maybe_bank(args, data["validation"], cfg, dev, log=log)
    banks = (valid_bank, valid_bank if data["eval"] is data["validation"]
             else maybe_bank(args, data["eval"], cfg, dev, log=log))

    for epoch in range(start_epoch, args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        if epoch == args.epochs_ls:
            log.info("entering the fine-tuning stage")
            best_path = osp.join(model_dir, f"{cfg.train.info}_1_best")
            if osp.exists(best_path):
                t = time.perf_counter()
                model.load_state_dict(load_checkpoint(best_path)["model"])
                record["checkpoint_s"] = time.perf_counter() - t
                record["reloaded"] = best_path
            fine_tune_stage()
            train_step = make_step()

        t0, folds0, graph0 = time.time(), FOLDS.copy(), train_step.graph.counts()
        lr_now = (1e-5 if epoch >= args.epochs_ls
                  else cfg.train.lr if not cfg.train.adjust_lr
                  else cfg.train.lr * cfg.train.lr_drop_gamma ** (epoch // cfg.train.lr_drop))
        acc, timer = train_one_epoch(train_step, concat, sampler, cfg, train_bank, gen, log)
        record["graph"] = train_step.graph.counts().since(graph0)
        means = _end_epoch(log, record, acc.totals(), acc.steps, timer, t0, folds0,
                           f"; {record['graph'].line()}")
        class_error = float(means.get("class_error", 0.0))
        _log_stats(log, means, weight_dict, class_error=class_error, lr=lr_now)
        record.update(loss_means=dict(means, loss=record["loss"], class_error=class_error),
                      lr=lr_now, fine_tune=fine_tune)

        _save_periodic(record, cfg, osp.join(model_dir, info), epoch, model, state.optimizer, gen,
                       {"sampler": sampler.rng}, policies)
        if (epoch + 1) % cfg.train.eval_interval != 0:
            continue
        _, stop = _validate(log, "Metric on validation", eval_step, cfg, data, valid_bank,
                            weight_dict, policies, record, osp.join(model_dir, info),
                            {"model": model.state_dict(), "epoch": epoch})
        if stop:
            break

    f1, final = _final_test(log, cfg, data, banks, osp.join(model_dir, info), restore, eval_step,
                            PSDS_THRESHOLDS if args.psds else None, args.roc_curves)
    return TrainResult(f1, epochs, final, bank=train_bank is not None and valid_bank is not None,
                       model_dir=model_dir, data_timings=data.get("timings", {}))

# ---------------------------------------------------------------------------
# SP-SEDT self-supervised pretraining
# ---------------------------------------------------------------------------


class PretrainResult(NamedTuple):
    """What :func:`run_spsedt` measured."""

    # per epoch: the loss means, steps, seconds, the wait for batches and
    # the checkpoint seconds
    epochs: List[Dict]
    bank: bool  # whether the feature bank held the features
    model_dir: str
    checkpoint: str  # the final checkpoint
    # on disk: seconds of the feature pass and the scaler, clips extracted
    data_timings: Dict


def spsedt_config(args) -> SEDTConfig:
    """The pretrainer's config: ``args`` with ``self_sup`` on, ``dec_at`` off
    and ``lr_backbone`` 0 (set on ``args`` too, as the JAX package does)."""
    args.self_sup = True
    args.dec_at = False
    args.lr_backbone = 0.0  # the backbone is frozen during pretraining
    return args_to_config(args)


def build_pretrain_data(cfg: SEDTConfig, args, rng: np.random.RandomState) -> Dict:
    """SP-SEDT's training set: ``--synthetic_smoke`` clips (unlabeled), or
    DCASE's ``unlabel_in_domain.tsv`` (with ``--extra_data`` also
    ``dcase2018_task5.tsv``, its rows after the first's) through ``SedData``,
    the scaler of that set (``<exp_root>/<dataset>.json``, computed and saved
    unless it exists) and ``DataLoadDf``.  Every item draws its patch boxes
    from ``rng``; the crops are gathered on the device."""
    enc = BoxEncoder(1, seconds=cfg.features.max_len_seconds, generate_patch=True)
    patch_kw = dict(num_patches=cfg.model.num_patches, fixed_patch_size=args.fixed_patch_size,
                    rng=rng)
    if args.synthetic_smoke:
        train = SyntheticDataset(args.smoke_clips, list(cfg.data.classes), cfg.model.max_frames,
                                 cfg.model.n_mels, enc.encode_strong_df, max_events=2, seed=0,
                                 unlabel=True, **patch_kw)
        return {"train": train, "timings": {}}
    root, ds = _sed_data(cfg)
    tsvs = ["unlabel_in_domain.tsv"] + (["dcase2018_task5.tsv"] if getattr(args, "extra_data", False)
                                      else [])
    t0 = time.perf_counter()
    rows = [r for tsv in tsvs for r in ds.initialize_and_get_df(
        osp.join(root, "metadata", "train", tsv), nb_files=cfg.data.nb_files)]
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": len(unique(r["filename"] for r in rows))}
    scaler = _fit_scaler(osp.join(cfg.data.exp_root, cfg.data.dataset_name + ".json"),
                         lambda: DataLoadDf(rows, transform=get_transforms(
                             cfg.model.max_frames, None, compute_log=True)), timings)
    train = DataLoadDf(rows, enc.encode_strong_df,
                       get_transforms(cfg.model.max_frames, scaler, compute_log=True),
                       in_memory=cfg.data.in_memory, device_patches=True, **patch_kw)
    return {"train": train, "timings": timings}


def run_spsedt(args, device: Optional[torch.device | str] = None) -> PretrainResult:
    """SP-SEDT self-supervised pretraining, on ``--synthetic_smoke`` clips or
    DCASE's unlabeled clips under ``--data_root``: no validation, a
    checkpoint every ``checkpoint_epochs`` epochs and a final one named
    ``info`` (``{"model", "epoch"}``, what ``run_supervised --pretrain``
    reads).

    Runs on ``device`` (the GPU when None).  With ``--pretrain`` the
    backbone's parameters come from that audio-tag checkpoint under the
    model dir (``load_audio_tag_backbone``, after the ImageNet init; the
    FrozenBN statistics stay the model's).  As in the JAX package it forces
    ``self_sup``, no ``dec_at`` and ``lr_backbone`` 0 (the backbone's
    trainable leaves keep their gradients, which count in the clip, and
    their AdamW update is exactly zero).  One ``np.random.RandomState(seed)``
    draws each epoch's permutation, then each item's patch boxes in batch
    order (on the prefetch thread, which ends with the epoch), as the JAX
    package draws them from numpy's global stream after seeding it.
    ``--resume`` restores the model, AdamW, that stream and the step's
    generator from a periodic checkpoint and goes on at the next epoch.  In a
    process group every rank draws the permutation and every row's patch
    boxes, and trains on its share of each batch.
    """
    cfg = spsedt_config(args)
    dev, log, model_dir = _set_up(args, device, cfg, [cfg.data.batch_size], "train_spsedt_torch",
                                  "SP-SEDT self-supervised pretraining (PyTorch)")
    rng = np.random.RandomState(cfg.train.seed)
    epochs: List[Dict] = []

    data = build_pretrain_data(cfg, args, rng)
    train_data = data["train"]
    bs = cfg.data.batch_size
    steps_per_epoch = max(len(train_data) // bs, 1)

    model, weight_dict = init_model(cfg, dev)
    log.info(f"params: {sum(p.numel() for p in model.parameters())}")
    _imagenet_backbone_init(model, args, log)
    if args.pretrain:  # the audio-tag backbone, after the ImageNet init
        loaded = load_audio_tag_backbone(
            model, load_checkpoint(osp.join(model_dir, args.pretrain))["model"])
        log.info(f"initialized the backbone from the audio-tag checkpoint {args.pretrain}: "
                 f"{len(loaded)} parameters")
    state = init_train_state(model, cfg, steps_per_epoch)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(cfg.train.seed))
    start_epoch = 0
    if args.resume:
        start_epoch = _resume(load_checkpoint(osp.join(model_dir, args.resume)), args.resume,
                              log, model, state.optimizer, gen, {"rng": rng})

    train_step = make_train_step(wrap_model(model, dev), weight_dict, cfg, state.optimizer,
                                 augment_on=False, device=dev)
    bank = maybe_bank(args, train_data, cfg, dev, log=log)

    for epoch in range(start_epoch, args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0, folds0, graph0 = time.time(), FOLDS.copy(), train_step.graph.counts()
        order = rng.permutation(len(train_data))
        index_batches = [order[b * bs:(b + 1) * bs].tolist() for b in range(len(order) // bs)]
        acc, timer = train_one_epoch(train_step, train_data, index_batches, cfg, bank, gen, log)
        record["graph"] = train_step.graph.counts().since(graph0)
        record["loss_means"] = _end_epoch(log, record, acc.totals(), acc.steps, timer, t0,
                                          folds0, f"; {record['graph'].line()}")
        _save_periodic(record, cfg, osp.join(model_dir, cfg.train.info), epoch, model,
                       state.optimizer, gen, {"rng": rng})
    final: Dict = {}
    _save(final, osp.join(model_dir, cfg.train.info), {"model": model.state_dict(),
                                                       "epoch": args.epochs})
    log.info(f"saved final pretrain checkpoint: {cfg.train.info} ({final['checkpoint_s']:.3f}s)")
    return PretrainResult(epochs, bank=bank is not None, model_dir=model_dir,
                          checkpoint=osp.join(model_dir, cfg.train.info),
                          data_timings=dict(data["timings"], final_checkpoint_s=final["checkpoint_s"]))

# ---------------------------------------------------------------------------
# semi-supervised mean-teacher trainer
# ---------------------------------------------------------------------------


def build_semi_data(cfg: SEDTConfig, args, batch_sizes: Sequence[int]) -> Dict:
    """The semi trainer's datasets: ``train`` is a :class:`ConcatDataset` of
    the strong, weak and unlabeled streams (in that order), with the
    validation and eval sets and the encoder.

    ``--synthetic_smoke``: generated clips with the JAX package's seeds
    (strong 0, weak 2, unlabeled 5, validation 1), each stream at least 4
    batches of its share.  On disk: ``build_real_data``'s DCASE streams and
    ``metadata/train/unlabel_in_domain.tsv`` through ``SedData`` and
    ``DataLoadDf`` with the training scaler."""
    if args.synthetic_smoke:
        enc, mk = _smoke_clips(cfg)
        n_strong = max(args.smoke_clips // 4, 4 * batch_sizes[0])
        n_weak = max(args.smoke_clips // 4, 4 * batch_sizes[1])
        n_unlab = max(args.smoke_clips // 2, 4 * batch_sizes[2])
        valid = mk(max(16, args.smoke_clips // 4), 1)
        return {"train": ConcatDataset([mk(n_strong, 0), mk(n_weak, 2, weak_only=True),
                                        mk(n_unlab, 5, unlabel=True)]),
                "validation": valid, "eval": valid, "encoder": enc,
                "ref_valid": valid.ref_rows(), "ref_eval": valid.ref_rows(), "timings": {}}
    data = build_real_data(cfg, args)
    root, ds = _sed_data(cfg)
    t0 = time.perf_counter()
    rows = ds.initialize_and_get_df(osp.join(root, "metadata", "train", "unlabel_in_domain.tsv"),
                                    nb_files=cfg.data.nb_files)
    t = data["timings"]
    t["features_s"] += time.perf_counter() - t0
    t["extracted"] += ds.n_extracted
    t["clips"] += len(unique(r["filename"] for r in rows))
    unlab = DataLoadDf(rows, data["encoder"].encode_strong_df,
                       get_transforms(cfg.model.max_frames, data["scaler"], compute_log=True),
                       in_memory=cfg.data.in_memory, cache_transformed=cfg.data.in_memory)
    data["train"] = ConcatDataset(list(data["train"].datasets) + [unlab])
    return data


def semi_views(feats: torch.Tensor, cfg: SEDTConfig,
               generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the teacher's clean view, the student's noisy one) of a batch, drawn
    from ``generator``: Gaussian noise at ``cfg.features.noise_snr`` on half
    the clips, then the masks ``cfg.augment`` turns on, on the student's view
    only."""
    a = cfg.augment
    clean, noisy = augment.gaussian_noise_pair(feats, generator, snr=cfg.features.noise_snr,
                                               p=0.5)
    if a.time_mask:
        noisy = augment.time_mask(noisy, generator)
    if a.freq_mask:
        noisy = augment.freq_mask(noisy, generator)
    if a.freq_shift:
        noisy = augment.freq_shift(noisy, generator)
    return clean, noisy


def run_semi(args, device: Optional[torch.device | str] = None) -> TrainResult:
    """The mean-teacher trainer, on ``--synthetic_smoke`` data or the DCASE
    dataset under ``--data_root``, with the final test's event-based F1 on
    the eval set (of the last fusion strategy, as the JAX package does) and
    what the run measured.

    Runs on ``device`` (the GPU when None).  A batch of
    ``--semi_batch_size`` holds a quarter strong, a quarter weak and half
    unlabeled clips.  The student starts from ``--teacher_model`` (a
    checkpoint ``{"model": ...}`` of ``run_supervised``, under the model
    dir; required unless ``--synthetic_smoke`` or ``--eval``), the teacher
    as its copy.  Per step, from the step's generator: the clean and noisy
    views, the masks on the noisy one, then ``make_semi_train_step``
    (cosine lr, the EMA every ``accumlating_ema_steps`` steps).  Per epoch:
    the pseudo counts summed with the metrics, the thresholds adapted from
    them (uploaded once for the next epoch), the teacher's
    (``--teacher_eval``, the default) or the student's validation (a best
    checkpoint holds both), a periodic checkpoint with the teacher and the
    thresholds.  Then the final test of each strategy's best teacher (or
    student).

    In a process group each rank's batch is its share of every stream (its
    local ``n_labeled`` is (strong + weak) / N), the pseudo counts are summed
    over the ranks before the thresholds adapt, and the teacher stays the
    same on every rank, as the student's parameters do.
    """
    if getattr(args, "from_wavs", False):
        raise ValueError("--from_wavs streams waveforms to the supervised trainer only")
    if not (args.teacher_model or args.synthetic_smoke or args.eval):
        raise SystemExit("please provide the teacher model (--teacher_model)")
    cfg = args_to_config(args)
    bs = args.semi_batch_size
    batch_sizes = [bs // 4, bs // 4, 2 * bs // 4]
    dev, log, model_dir = _set_up(args, device, cfg, batch_sizes, "train_ss_sedt_torch",
                                  "Semi-supervised SEDT, mean teacher (PyTorch)")
    local = local_sizes(batch_sizes, data_world())
    np.random.seed(cfg.train.seed)
    epochs: List[Dict] = []
    nc = cfg.model.num_classes

    data = build_semi_data(cfg, args, batch_sizes)
    concat = data["train"]
    sampler = MultiStreamBatchSampler(concat, batch_sizes, seed=cfg.train.seed)
    steps_per_epoch = max(len(sampler), 1)

    model, weight_dict = init_model(cfg, dev)
    if args.teacher_model:
        model.load_state_dict(load_checkpoint(osp.join(model_dir, args.teacher_model))["model"])
        log.info(f"using teacher model: {args.teacher_model}")
    state = init_train_state(model, cfg, steps_per_epoch, schedule="cosine")
    teacher = make_teacher(model)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(cfg.train.seed))
    prior = np.asarray(C.DCASE_CLASS_PRIOR[:nc], np.float64)
    prior = prior / prior.sum()
    origin_threshold = np.full((nc,), 0.5)
    thresholds = origin_threshold.copy()
    policies = _policies(cfg)
    start_epoch = 0
    if args.resume:
        ck = load_checkpoint(osp.join(model_dir, args.resume))
        start_epoch = _resume(ck, args.resume, log, model, state.optimizer, gen,
                              {"sampler": sampler.rng}, policies)
        teacher.load_state_dict(ck["teacher"])
        if "optimizer" in ck:
            thresholds = ck["classwise_threshold"].numpy()

    semi_step = make_semi_train_step(weight_dict, cfg, fine_tune=cfg.train.fine_tune,
                                     normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                                     n_labeled=local[0] + local[1], device=dev)
    eval_steps = {"teacher": make_eval_step(teacher, weight_dict, cfg, cfg.train.fusion_strategy,
                                            device=dev),
                  "student": make_eval_step(model, weight_dict, cfg, cfg.train.fusion_strategy,
                                            device=dev)}
    evaluated = "teacher" if args.teacher_eval else "student"
    # the fixed (local) batch layout's flags by position (the strong
    # stream's rows are strong whether or not they hold events)
    pos = torch.arange(sum(local))
    flags = [f.to(dev) for f in (pos < local[0], (pos >= local[0])
                                 & (pos < local[0] + local[1]), pos >= local[0] + local[1])]
    # DDP after the freeze; the checkpoints save the unwrapped `model`
    state = state._replace(model=wrap_model(model, dev))
    train_bank = maybe_bank(args, concat, cfg, dev, log=log)
    valid_bank = maybe_bank(args, data["validation"], cfg, dev, log=log)
    banks = (valid_bank, valid_bank if data["eval"] is data["validation"]
             else maybe_bank(args, data["eval"], cfg, dev, log=log))

    def epoch_step(threshold_dev: torch.Tensor):
        """The step of one epoch as ``train_one_epoch`` calls it: the view
        pair and the masks, then the semi step, the EMA by the epoch's step
        count; the pseudo counts join the metrics."""
        done = 0

        def step(batch, generator):
            nonlocal done
            teacher_feats, student_feats = semi_views(batch.feats.to(dev, non_blocking=True),
                                                      cfg, generator)
            done += 1
            metrics, counts = semi_step(state, teacher, teacher_feats, student_feats,
                                        batch.pad_mask, batch.targets, *flags, threshold_dev,
                                        generator, done % cfg.train.accumlating_ema_steps == 0)
            return dict(metrics, pseudo_counts=counts)

        step.device = dev
        return step

    def restore(ck):
        (teacher if args.teacher_eval else model).load_state_dict(
            ck["teacher" if args.teacher_eval else "model"])
        log.info(f"using the {evaluated} for the test")
        return eval_steps[evaluated]

    semi_weights = ({f"sup_{k}": v for k, v in weight_dict.items()}
                    | {f"unsup_{k}": v for k, v in weight_dict.items()})
    for epoch in range(start_epoch, args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0, folds0 = time.time(), FOLDS.copy()
        # the thresholds go to the device once an epoch, compared in f32
        threshold_dev = torch.as_tensor(thresholds, dtype=torch.float32).to(dev)
        acc, timer = train_one_epoch(epoch_step(threshold_dev), concat, sampler, cfg, train_bank,
                                     gen, log)
        sums = acc.totals()  # the one fetch (and reduction) of the epoch
        counts = sums.pop("pseudo_counts", np.zeros(nc))
        means = _end_epoch(log, record, sums, acc.steps, timer, t0, folds0,
                           f"; pseudo counts {counts.astype(int).tolist()}")
        thresholds = adjust_threshold(counts, origin_threshold, prior)
        _log_stats(log, means, semi_weights)
        record.update(loss_means=means, pseudo_counts=counts.tolist(),
                      thresholds=thresholds.tolist())

        _, stop = _validate(log, f"{evaluated} model validation", eval_steps[evaluated], cfg, data,
                            valid_bank, weight_dict, policies, record,
                            osp.join(model_dir, cfg.train.info),
                            {"model": model.state_dict(), "teacher": teacher.state_dict(),
                             "epoch": epoch})
        _save_periodic(record, cfg, osp.join(model_dir, cfg.train.info), epoch, model,
                       state.optimizer, gen, {"sampler": sampler.rng}, policies,
                       teacher=teacher.state_dict(),
                       classwise_threshold=torch.from_numpy(np.asarray(thresholds, np.float64)))
        if stop:
            break

    # the final test of each strategy's best teacher (or student); without a
    # best checkpoint the model last loaded is tested, the student at first
    f1, final = _final_test(log, cfg, data, banks, osp.join(model_dir, cfg.train.info), restore,
                            eval_steps["student"])
    tested = "student"
    for record in final:
        tested = evaluated if "loaded" in record else tested
        record["model"] = tested
    return TrainResult(f1, epochs, final, bank=train_bank is not None and valid_bank is not None,
                       model_dir=model_dir, data_timings=data.get("timings", {}))

# ---------------------------------------------------------------------------
# audio-tag backbone trainer
# ---------------------------------------------------------------------------

AT_CLIP_MAX_NORM = 0.1  # the JAX package's fixed clip; --clip_max_norm is not read


class AudioTagResult(NamedTuple):
    """What :func:`run_audio_tag` measured."""

    f1: float  # the last epoch's clip macro F1 on validation
    # per epoch: the loss mean, steps, seconds, the wait for batches, the
    # validation's seconds and F1, the checkpoint seconds
    epochs: List[Dict]
    model_dir: str
    checkpoint: str  # at_<pooling>_<dataset>, saved on every new best F1
    # on disk: seconds of the feature pass and the scaler, clips extracted
    data_timings: Dict


def build_audio_tag_data(cfg: SEDTConfig, args) -> Dict:
    """The audio-tag trainer's datasets, labels encoded as [C] multi-hot by
    ``ManyHotEncoder.encode_weak``: ``--synthetic_smoke`` clips (clip labels
    only; seed 0 for training, 16 clips of seed 1 for validation), or on
    disk URBAN-SED's train and validate TSVs, or DCASE's weak and synthetic
    (in that order) and validation TSVs, through ``SedData``, the frame
    transforms and ``DataLoadDf``.  The scaler covers the training streams
    and is saved at ``<exp_root>/<dataset>_at.json``, or loaded from there
    when that file exists."""
    classes = list(cfg.data.classes)
    m = cfg.model
    mhe = ManyHotEncoder(classes, n_frames=m.max_frames)
    if args.synthetic_smoke:
        mk = lambda n, seed: SyntheticDataset(n, classes, m.max_frames, m.n_mels, mhe.encode_weak,
                                              max_events=2, seed=seed, weak_only=True)
        valid = mk(16, 1)
        return {"train": mk(args.smoke_clips, 0), "validation": valid,
                "ref_valid": valid.ref_rows(), "encoder": mhe, "timings": {}}
    _, ds = _sed_data(cfg)
    paths, audio_dirs = real_data_paths(cfg)
    paths.pop("eval")
    train_keys = ["train"] if "train" in paths else ["weak", "synthetic"]
    t0 = time.perf_counter()
    dfs = get_dfs(ds, paths, nb_files=cfg.data.nb_files, audio_dirs=audio_dirs)
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": sum(len(unique(r["filename"] for r in rows)) for rows in dfs.values())}
    scaler = _fit_scaler(osp.join(cfg.data.exp_root, cfg.data.dataset_name + "_at.json"),
                         lambda: ConcatDataset([DataLoadDf(dfs[k], transform=get_frame_transforms(
                             m.max_frames, None, compute_log=True)) for k in train_keys]), timings)
    tf = get_frame_transforms(m.max_frames, scaler, compute_log=True)
    cache = cfg.data.in_memory
    train = ConcatDataset([DataLoadDf(dfs[k], mhe.encode_weak, tf, in_memory=cache,
                                      cache_transformed=cache) for k in train_keys])
    valid = DataLoadDf(dfs["validation"], mhe.encode_weak, tf, cache_transformed=cache)
    return {"train": train, "validation": valid, "ref_valid": ref_rows(dfs["validation"]),
            "encoder": mhe, "timings": timings}


def audio_tag_ast(args, cfg: SEDTConfig) -> Tuple[SEDTConfig, Optional[ASTConfig]]:
    """``(cfg, ast)``: with ``--at_model ast`` AST's settings, the published
    AudioSet model (:data:`~.models.AUDIOSET`); else ``(cfg, None)``.  On
    ``--synthetic_smoke`` the clips take AST's geometry (frames, mel bins and
    classes ``class_0`` ...); on a dataset from disk AST takes the data's, as
    the upstream recipes set ``input_tdim``, ``input_fdim`` and ``label_dim``
    per dataset, and keeps its widths."""
    if getattr(args, "at_model", "resnet") != "ast":
        return cfg, None
    ast = AUDIOSET
    if args.synthetic_smoke:
        classes = tuple(f"class_{i}" for i in range(ast.num_classes))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, max_frames=ast.frames,
                                                    n_mels=ast.n_mels),
                          data=dataclasses.replace(cfg.data, classes=classes))
    else:
        ast = dataclasses.replace(ast, n_mels=cfg.model.n_mels, frames=cfg.model.max_frames,
                                  num_classes=len(cfg.data.classes))
    return cfg, ast


def init_audio_tag_model(cfg: SEDTConfig, pooling: str, device: torch.device,
                         ast: Optional[ASTConfig] = None) -> torch.nn.Module:
    """The audio-tag model to train (logits out): ``AudioTagBackbone``, or
    :class:`~.models.AST` at ``ast`` when given; parameters drawn on the CPU
    from ``cfg.train.seed``, then moved to ``device``."""
    m = cfg.model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        if ast is not None:
            model = AST(ast)
        else:
            model = AudioTagBackbone(m.backbone, m.dilation, pooling, len(cfg.data.classes),
                                     logits_out=True)
    return model.to(device).eval()


def audio_tag_dtype(cfg: SEDTConfig, ast: Optional[ASTConfig]) -> Optional[torch.dtype]:
    """The audio-tag step's autocast dtype: ``--compute_dtype`` for AST (its
    recipe trains under autocast), None (f32) for ``AudioTagBackbone``, which
    computes in f32 as the JAX package's does whatever that flag says."""
    if ast is None or cfg.model.compute_dtype == "float32":
        return None
    return getattr(torch, cfg.model.compute_dtype)


def make_audio_tag_step(model: torch.nn.Module, optimizer: SEDTOptimizer,
                        compute_dtype: Optional[torch.dtype] = None):
    """One audio-tag update on a batch already on the model's device
    (features [B, T, F, 1], multi-hot labels [B, C]): the BCE on the logits,
    averaged over B x C, its backward, then the optimizer (the clip and Adam
    for ``AudioTagBackbone``, AST's Adam for AST).  Returns the loss on the
    device (not fetched).  The forward and the loss run under autocast to
    ``compute_dtype`` when given (the BCE in f32, as autocast computes it),
    else in f32.  Its parts run in the spans ``train.forward`` (the model
    and the BCE), ``train.backward`` and ``train.optimizer``.

    In a process group ``model`` is DDP-wrapped and the batch is this rank's
    share: the local mean is N times the rank's partial of the global mean,
    its gradient's mean over the ranks is the global one, and the step
    returns the partial."""
    world = data_world()

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with same_bits_on_every_rank():  # a model group's ranks compute it side by side
            cast = (contextlib.nullcontext() if compute_dtype is None
                    else torch.autocast(x.device.type, dtype=compute_dtype))
            with annotate("train.forward"), cast:
                loss = F.binary_cross_entropy_with_logits(model(x), y)
            with annotate("train.backward"):
                loss.backward()
        with annotate("train.optimizer"):
            optimizer.step()
        return loss.detach() / world if world > 1 else loss.detach()

    return step


def train_audio_tag_epoch(step, dataset, index_batches: Sequence[Sequence[int]],
                          device: torch.device):
    """One pass of the audio-tag trainer over ``index_batches`` (global index
    lists) of ``dataset`` through ``step`` (:func:`make_audio_tag_step`), on
    this rank's share of each batch, built on the prefetch thread
    (``weak_batches``, pinned) and copied to ``device`` in ``train.step``;
    returns the loss summed on the device and the step timer
    (:func:`_epoch_loop`, its heartbeat to the logger ``train_at_torch``)."""
    batches = weak_batches(dataset, index_batches, pin_memory=device.type == "cuda")
    return _epoch_loop(batches, len(index_batches),
                       lambda xy: {"loss": step(xy[0].to(device, non_blocking=True),
                                                xy[1].to(device, non_blocking=True))},
                       None, logging.getLogger("train_at_torch"))

def k4_summary(launches0: int, backward0: int, recomputes0: int, steps: int) -> str:
    """Kernel K4's forward launches, backward kernel calls and backward
    recomputes a step since the counts ``launches0``, ``backward0`` and
    ``recomputes0``."""
    per = lambda n: n / max(steps, 1)
    return (f"K4 a step: {per(flash_attention.launches - launches0):.1f} launches, "
            f"{per(flash_attention.backward_launches - backward0):.1f} backward kernels, "
            f"{per(flash_attention.recomputes - recomputes0):.1f} recomputes")


@torch.no_grad()
def audio_tag_rows(model: AudioTagBackbone, dataset, encoder: ManyHotEncoder, batch_size: int,
                   device: torch.device) -> Optional[List[Tuple]]:
    """The tags of every clip of ``dataset`` (sigmoid > 0.5), in order at
    ``batch_size`` with a ragged last batch, as metric rows ``(filename, 0,
    0, label)``.  In a process group each rank tags a contiguous 1/N of the
    batches and the rows are gathered on rank 0 (None on the others)."""
    n = len(dataset)
    index_batches = [list(range(b, min(b + batch_size, n))) for b in range(0, n, batch_size)]
    rank, world = data_rank(), data_world()
    per_rank = -(-len(index_batches) // world)
    index_batches = index_batches[rank * per_rank:(rank + 1) * per_rank]
    rows: List[Tuple] = []
    for idxs, (x, _) in zip(index_batches, weak_batches(dataset, index_batches,
                                                        pin_memory=device.type == "cuda",
                                                        host_slice=(0, 1))):
        tags = (torch.sigmoid(model(x.to(device, non_blocking=True))) > 0.5).cpu().numpy()
        for i, row in zip(idxs, tags):
            rows.extend((dataset.filenames[i], 0.0, 0.0, lbl)
                        for lbl in encoder.decode_weak(row.astype(int)))
    return gather_rows(rows)


def run_audio_tag(args, device: Optional[torch.device | str] = None) -> AudioTagResult:
    """The audio-tag trainer, on ``--synthetic_smoke`` clips or the dataset
    under ``--data_root`` (``build_audio_tag_data``), returning the last
    validation's clip macro F1 and what the run measured.

    Runs on ``device`` (the GPU when None).  The model is
    ``AudioTagBackbone`` at ``--backbone``, ``--dilation`` and ``--pooling``
    (avg when unset), from an ImageNet backbone when one is named or
    present: each update the BCE on the logits, then the clip of the global
    norm at 0.1 over every parameter (nothing is frozen) and Adam at
    ``--lr``, times 0.1 every ``--lr_drop`` epochs; f32, without autocast.
    With ``--at_model ast`` it is AST (:func:`audio_tag_ast`) from seeded
    weights: the BCE under autocast to ``--compute_dtype``, then AST's Adam
    (:func:`~.parallel.optim.make_ast_optimizer`) at ``--lr`` (1e-5 unless
    given), halved every epoch from epoch 2.  Per epoch
    (:func:`train_audio_tag_epoch`): one permutation from a
    ``RandomState(seed)`` (the JAX package's draw from numpy's seeded global
    stream), its full batches (the ragged tail dropped); then the clip tags
    of the validation set and their macro F1, and on a new best F1 the
    checkpoint ``{"model", "epoch"}`` at
    ``<exp_root>/<dataset>/model/at_<pooling>_<dataset>`` (``at_ast_...``
    for AST).  In a process group each rank trains on its contiguous share
    of every batch under DDP; rank 0 scores the gathered tags and decides
    the checkpoint.
    """
    cfg, ast = audio_tag_ast(args, args_to_config(args))
    dev, log, model_dir = _set_up(args, device, cfg, [cfg.data.batch_size], "train_at_torch",
                                  "Audio-tag backbone trainer (PyTorch)")
    rng = np.random.RandomState(cfg.train.seed)
    pooling = args.pooling or "avg"
    epochs: List[Dict] = []

    data = build_audio_tag_data(cfg, args)
    train_data, valid, mhe = data["train"], data["validation"], data["encoder"]
    bs = cfg.data.batch_size
    model = init_audio_tag_model(cfg, pooling, dev, ast)
    if ast is None:
        _imagenet_backbone_init(model, args, log)
    log.info(f"params: {sum(p.numel() for p in model.parameters())}")
    steps_per_epoch = max(len(train_data) // bs, 1)
    if ast is None:
        optimizer = make_audio_tag_optimizer(model, args.lr, args.lr_drop, steps_per_epoch,
                                             AT_CLIP_MAX_NORM)
    else:
        optimizer = make_ast_optimizer(model, args.lr, steps_per_epoch)
    step = make_audio_tag_step(wrap_model(model, dev), optimizer,
                               compute_dtype=audio_tag_dtype(cfg, ast))
    best = SaveBest("sup")
    name = "ast" if ast is not None else pooling
    model_path = osp.join(model_dir, f"at_{name}_{cfg.data.dataset_name}")
    f1 = 0.0
    for epoch in range(args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0, folds0 = time.time(), FOLDS.copy()
        k4 = (flash_attention.launches, flash_attention.backward_launches,
              flash_attention.recomputes)
        order = rng.permutation(len(train_data))
        index_batches = [order[b * bs:(b + 1) * bs].tolist() for b in range(len(order) // bs)]
        acc, timer = train_audio_tag_epoch(step, train_data, index_batches, dev)
        _end_epoch(log, record, acc.totals(), acc.steps, timer, t0, folds0,
                   f"; {k4_summary(*k4, acc.steps)}")

        t0 = time.perf_counter()
        rows = audio_tag_rows(model, valid, mhe, bs, dev)

        def score():
            f1 = audio_tagging_results(data["ref_valid"], rows)["avg"][0]
            return f1, best.apply(f1)

        f1, is_best = _on_main(score)
        record.update(val_s=time.perf_counter() - t0, f1=f1)
        log.info(f"AT clip macro F1: {f1:.4f}")
        if is_best:
            _save(record, model_path, {"model": model.state_dict(), "epoch": epoch})
    log.info(f"best AT model saved at {model_path}")
    return AudioTagResult(f1, epochs, model_dir=model_dir, checkpoint=model_path,
                          data_timings=data["timings"])
