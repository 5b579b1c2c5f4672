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
* ``run_supervised``: the supervised trainer (epochs, evaluation, best
  checkpoints per fusion strategy, early stopping, the fine-tune stage from
  ``--epochs_ls``, resume, the final test; an ImageNet backbone from a
  torchvision ``.pth``; with ``--from_wavs`` the frontend inside the train
  step; with ``--pretrain`` an SP-SEDT checkpoint carried over by
  ``utils.checkpoint.load_pretrain_into``), returning a :class:`TrainResult`;
* ``run_spsedt``: SP-SEDT self-supervised pretraining (patch queries on
  unlabeled clips, ``--synthetic_smoke`` or DCASE's
  ``unlabel_in_domain.tsv`` and with ``--extra_data`` its 2018 task 5 TSV;
  the backbone from an audio-tag checkpoint with ``--pretrain``; periodic
  and final checkpoints, resume), returning a :class:`PretrainResult`;
* ``run_semi``: the mean-teacher semi-supervised trainer (strong, weak and
  unlabeled clips in every batch, the clean/noisy view pair, the EMA
  teacher's pseudo-labels, class-wise thresholds adapted each epoch, the
  teacher's or the student's evaluation, checkpoints, resume), returning a
  :class:`TrainResult`;
* ``run_audio_tag``: the audio-tag backbone trainer (clip tags by a
  logit-space BCE on ``AudioTagBackbone``, clipped Adam, the validation's
  clip macro F1 and a best checkpoint, which ``run_spsedt --pretrain``
  reads), returning an :class:`AudioTagResult`.

Several processes raise ``NotImplementedError``, naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import os.path as osp
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from .models import AudioTagBackbone, build_model, resolve_device
from .models.torch_import import load_imagenet_backbone
from .ops import augment
from .ops.frontend import make_frontend_fn
from .parallel.distribute import get_reduced_loss, get_world_size
from .parallel.optim import SEDTOptimizer, make_audio_tag_optimizer
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
from .utils.profiler import StepTimer

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


def build_synthetic_data(cfg: SEDTConfig, args) -> Dict:
    """The ``--synthetic_smoke`` datasets and encoder.  DCASE mode (with
    ``n_weak`` > 0) trains on a strong and a weak stream; validation and
    eval are one set of ``max(8, smoke_clips // 4)`` clips."""
    classes = list(cfg.data.classes)
    enc = BoxEncoder(classes, seconds=cfg.features.max_len_seconds)
    mk = lambda n, seed, **kw: SyntheticDataset(
        n, classes, cfg.model.max_frames, cfg.model.n_mels, enc.encode_strong_df,
        max_events=min(3, cfg.model.max_events), seconds=cfg.features.max_len_seconds,
        seed=seed, **kw)
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


def build_real_data(cfg: SEDTConfig, args) -> Dict:
    """The datasets on disk under ``<data_root>/<dataset>``.

    Each split's TSV goes through ``SedData`` (the missing ``.npy`` mel
    amplitudes are extracted, without the dB, which the transform takes per
    clip).  The scaler is computed over the training split (DCASE: weak then
    synthetic) and saved at ``<exp_root>/<dataset>.json``, or loaded from
    there when that file exists.  Training reads ``.npy`` features through
    dB -> pad -> normalize, or with ``--from_wavs`` raw waveforms
    (``WavLoadDf``; the returned ``frontend`` arguments build the step's
    frontend from the same scaler); validation and eval always read
    ``.npy``.  ``timings`` holds the seconds of the feature pass and of the
    scaler, and the clips extracted.
    """
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    ds = SedData(cfg.data.dataset_name, base_feature_dir=osp.join(root, "features"),
                 compute_log=False)
    paths, audio_dirs = real_data_paths(cfg)
    t0 = time.perf_counter()
    dfs = get_dfs(ds, paths, nb_files=cfg.data.nb_files, audio_dirs=audio_dirs)
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": sum(len(unique(r["filename"] for r in rows)) for rows in dfs.values())}
    if cfg.data.max_strong_clips and "synthetic" in dfs:
        dfs["synthetic"] = cap_strong_clips(dfs["synthetic"], cfg.data.max_strong_clips)
    enc = BoxEncoder(list(cfg.data.classes), seconds=cfg.features.max_len_seconds)

    scaler = Scaler()
    scaler_path = osp.join(cfg.data.exp_root, cfg.data.dataset_name + ".json")
    t0 = time.perf_counter()
    if osp.isfile(scaler_path):
        scaler.load(scaler_path)
    else:
        base_tf = get_transforms(cfg.model.max_frames, None, compute_log=True)
        pre = ConcatDataset([DataLoadDf(dfs[s], transform=base_tf)
                             for s in (["train"] if "train" in dfs else ["weak", "synthetic"])])
        scaler.calculate_scaler(pre.features_only(i)[0] for i in range(len(pre)))
        os.makedirs(osp.dirname(scaler_path), exist_ok=True)
        scaler.save(scaler_path)
    timings["scaler_s"] = time.perf_counter() - t0

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
    mark = time.perf_counter()
    for batch in batch_iterator(dataset, bs, cfg.model.max_events, seconds,
                                return_indexes=True, bank=bank, pin_memory=pin):
        idxs = batch.indexes.numpy()
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

    t0 = time.perf_counter()
    means: Dict[str, float] = {}
    if loss_acc is not None and loss_acc.steps:
        means, _ = loss_acc.means()
        vlog = MetricLogger(delimiter="  ")
        get_reduced_loss(means, weight_dict, vlog)
        log.info("Val averaged stats:\n" + str(vlog))
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
    return EvalResult(metrics, means, psds_values,
                      dict(eval_steps_s=t_steps, decode_s=t_decode, metrics_s=t_metrics,
                           psds_s=t_psds, batches=n_batches))


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


def _imagenet_backbone_path(args) -> Optional[str]:
    """The torchvision checkpoint to load into the backbone:
    ``--imagenet_backbone``, else ``<data_root>/<backbone>.pth`` when that
    file exists."""
    path = getattr(args, "imagenet_backbone", None)
    if not path:
        auto = osp.join(args.data_root, f"{args.backbone}.pth")
        path = auto if osp.isfile(auto) else None
    return path


def _imagenet_backbone_init(model, args, log) -> Optional[str]:
    """Load the ImageNet backbone (``_imagenet_backbone_path``) into
    ``model.backbone``, or warn that the backbone trains from scratch;
    returns the path loaded."""
    path = _imagenet_backbone_path(args)
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


def _check_ported(args) -> None:
    """Raise for the paths of the trainers that this port does not have yet."""
    if get_world_size() > 1:
        raise NotImplementedError("training over several processes waits for multi-GPU "
                                  "(ROADMAP queue 1, item 7)")


def _rng_state(rng: np.random.RandomState) -> Dict:
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_rng_state(rng: np.random.RandomState, st: Dict) -> None:
    rng.set_state(("MT19937", st["keys"].numpy().astype(np.uint32), st["pos"],
                   st["has_gauss"], st["cached_gaussian"]))


def train_one_epoch(train_step, dataset, sampler, cfg: SEDTConfig, bank, generator, log):
    """One pass of ``sampler`` (index lists) over ``dataset`` through
    ``train_step``; returns the metrics summed on the device (a
    :class:`DeviceMetricAccumulator`, not yet fetched) and the step timer.
    Batches are pinned for the card, and with ``bank`` their features are
    gathered there."""
    acc = DeviceMetricAccumulator()
    timer = StepTimer()  # its data_time: the wait for each batch
    hb = Heartbeat(log.info, len(sampler))
    for i, batch in enumerate(batch_iterator(dataset, iter(sampler), cfg.model.max_events,
                                             cfg.features.max_len_seconds, bank=bank,
                                             pin_memory=train_step.device.type == "cuda")):
        timer.data_loaded()
        if bank is not None:
            batch = batch._replace(feats=bank.gather(batch.indexes), indexes=None)
        m = train_step(batch, generator)
        acc.update(m)  # summed on the device; no host sync
        timer.step_done()
        hb.tick(i)
        # a finiteness probe every 500 steps bounds the compute lost to a
        # NaN; the epoch-end check is the backstop
        if (i + 1) % 500 == 0 and not math.isfinite(float(m["loss"])):
            log.info("Loss is not finite (mid-epoch probe), stopping")
            raise SystemExit(1)
    return acc, timer


def run_supervised(args, device: Optional[torch.device | str] = None) -> TrainResult:
    """The supervised trainer, on ``--synthetic_smoke`` data or on the
    dataset under ``--data_root``, with the final test's event-based F1 on
    the eval set (of the last fusion strategy, as the JAX package does) and
    what the run measured.

    Runs on ``device`` (the GPU when None).  The backbone starts from an
    ImageNet checkpoint when one is named or present.  Per epoch: the train
    steps (with ``--from_wavs`` on raw waveforms, featurised inside the step,
    and without a feature bank: the host streams the audio), with the
    metrics summed on the device and fetched once at the epoch's end;
    every ``eval_interval`` epochs, ``evaluate`` on the validation set and a
    best checkpoint per fusion strategy; from epoch ``epochs_ls`` on, the
    fine-tune stage.  Then the final test of each strategy's best
    checkpoint on validation and eval (PSDS with ``--psds``).
    """
    dev = resolve_device(device)
    _check_ported(args)
    cfg = args_to_config(args)
    if args.log:
        set_logger(cfg.train.info)
    log = create_logger("train_sedt_torch")
    log.info("Sound Event Detection Transformer (PyTorch)")
    np.random.seed(cfg.train.seed)
    epochs: List[Dict] = []
    final: List[Dict] = []

    data = build_synthetic_data(cfg, args) if args.synthetic_smoke else build_real_data(cfg, args)
    enc = data["encoder"]
    store_dir = osp.join(cfg.data.exp_root, cfg.data.dataset_name)
    model_dir = osp.join(store_dir, "model")
    os.makedirs(model_dir, exist_ok=True)
    if args.back_up:
        back_up_code(store_dir, cfg.train.info)

    concat = (data["train"] if isinstance(data["train"], ConcatDataset)
              else ConcatDataset([data["train"]]))
    if len(concat.datasets) == 2:
        batch_sizes = [cfg.data.batch_size - cfg.data.n_weak, cfg.data.n_weak]
    else:
        batch_sizes = [cfg.data.batch_size]
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
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    best_saver = {m: SaveBest("sup") for m in cfg.train.fusion_strategy}
    early = EarlyStopping(patience=cfg.train.early_stopping_patience,
                          init_patience=cfg.train.early_stopping_init_wait,
                          fusion_strategy=cfg.train.fusion_strategy)
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
        model.load_state_dict(ck["model"])
        start_epoch = int(ck.get("epoch", -1)) + 1
        if start_epoch > args.epochs_ls:
            fine_tune_stage()
        if "optimizer" in ck:
            state.optimizer.load_state_dict(ck["optimizer"])
            _set_rng_state(sampler.rng, ck["sampler"])
            gen.set_state(ck["generator"])
            for m, sd in ck["save_best"].items():
                best_saver[m].load_state_dict(sd)
            early.load_state_dict(ck["early"])
        log.info(f"resumed from {args.resume}: epoch {start_epoch} next")

    frontend_fn = None
    if data.get("frontend") is not None:  # --from_wavs
        frontend_fn = make_frontend_fn(max_frames=cfg.model.max_frames, compute_log=True,
                                       **data["frontend"])
        log.info("waveform frontend inside the train step (--from_wavs)")

    def make_step():
        return make_train_step(model, weight_dict, cfg, state.optimizer, fine_tune=fine_tune,
                               normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                               frontend_fn=frontend_fn, device=dev)

    train_step = make_step()
    eval_step = make_eval_step(model, weight_dict, cfg, cfg.train.fusion_strategy, device=dev)
    # --from_wavs measures the streaming path: the host ships the audio of
    # every step, so its waveforms are not banked
    train_bank = None if frontend_fn is not None else maybe_bank(args, concat, cfg, dev, log=log)
    valid_bank = maybe_bank(args, data["validation"], cfg, dev, log=log)
    eval_bank = (valid_bank if data["eval"] is data["validation"]
                 else maybe_bank(args, data["eval"], cfg, dev, log=log))

    def save(name: str, content: Dict, record: Dict) -> None:
        t = time.perf_counter()
        save_checkpoint(osp.join(model_dir, name), content)
        record["checkpoint_s"] = record.get("checkpoint_s", 0.0) + time.perf_counter() - t

    metrics: Dict[int, float] = {}
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

        t0 = time.time()
        mlog = MetricLogger(delimiter="  ")
        lr_now = (1e-5 if epoch >= args.epochs_ls
                  else cfg.train.lr if not cfg.train.adjust_lr
                  else cfg.train.lr * cfg.train.lr_drop_gamma ** (epoch // cfg.train.lr_drop))
        acc, timer = train_one_epoch(train_step, concat, sampler, cfg, train_bank, gen, log)
        means, n_steps = acc.means()  # the one fetch of the epoch
        train_s = time.time() - t0
        loss_mean = float(means.pop("loss", float("nan")))
        class_error = float(means.pop("class_error", 0.0))
        get_reduced_loss(means, weight_dict, mlog)
        mlog.update(loss=loss_mean, class_error=class_error, lr=lr_now)
        mlog.synchronize_between_processes()
        log.info(f"Epoch {epoch}: loss {loss_mean:.4f} ({n_steps} steps, {train_s:.1f}s) "
                 f"{timer.summary()}")
        log.info("Train averaged stats:\n" + str(mlog))
        record.update(loss=loss_mean, loss_means=dict(means, loss=loss_mean,
                                                      class_error=class_error),
                      lr=lr_now, steps=n_steps, train_s=train_s, fine_tune=fine_tune,
                      data_wait_s=timer.data_time.sum)
        if not math.isfinite(loss_mean):
            log.info(f"Loss is {loss_mean}, stopping training")
            raise SystemExit(1)

        if cfg.train.checkpoint_epochs and (epoch + 1) % cfg.train.checkpoint_epochs == 0:
            save(f"{info}_{epoch}", {
                "model": model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "epoch": epoch, "sampler": _rng_state(sampler.rng),
                "generator": gen.get_state(),
                "save_best": {m: s.state_dict() for m, s in best_saver.items()},
                "early": early.state_dict()}, record)
        if (epoch + 1) % cfg.train.eval_interval != 0:
            continue
        log.info("Metric on validation")
        res = evaluate(eval_step, data["validation"], cfg, enc, data["ref_valid"],
                       cfg.train.fusion_strategy, at=cfg.model.dec_at,
                       weight_dict=weight_dict, bank=valid_bank)
        metrics = res.f1
        record.update(val_loss_means=res.loss_means, val_f1=dict(metrics),
                      eval_timings=res.timings)
        stop = False
        for m, f1 in metrics.items():
            if best_saver[m].apply(f1):
                # no optimizer state: a best checkpoint is read for its model
                # only (the fine-tune reload, the final test)
                save(f"{info}_{m}_best", {"model": model.state_dict(), "epoch": epoch,
                                          f"event_based_f1_{m}": f1}, record)
            if early.apply(f1):
                log.warning("EARLY STOPPING")
                stop = True
        if stop:
            break

    # the final test of each strategy's best model
    for m in cfg.train.fusion_strategy:
        record = {"fusion_strategy": m}
        final.append(record)
        best_path = osp.join(model_dir, f"{info}_{m}_best")
        if osp.exists(best_path):
            t = time.perf_counter()
            model.load_state_dict(load_checkpoint(best_path)["model"])
            record.update(checkpoint_s=time.perf_counter() - t, loaded=best_path)
        log.info("Metric on validation")
        res = evaluate(eval_step, data["validation"], cfg, enc, data["ref_valid"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True, bank=valid_bank)
        record.update(valid_f1=res.f1[m], valid_timings=res.timings)
        log.info("Metric on eval")
        res = evaluate(eval_step, data["eval"], cfg, enc, data["ref_eval"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True,
                       psds_thresholds=PSDS_THRESHOLDS if args.psds else None, bank=eval_bank,
                       roc_curves=args.roc_curves)
        metrics = res.f1
        record.update(eval_f1=metrics[m], eval_timings=res.timings, psds=res.psds)
    return TrainResult(metrics, epochs, final,
                       bank=train_bank is not None and valid_bank is not None,
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
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    ds = SedData(cfg.data.dataset_name, base_feature_dir=osp.join(root, "features"),
                 compute_log=False)
    tsvs = ["unlabel_in_domain.tsv"] + (["dcase2018_task5.tsv"] if getattr(args, "extra_data", False)
                                      else [])
    t0 = time.perf_counter()
    rows = [r for tsv in tsvs for r in ds.initialize_and_get_df(
        osp.join(root, "metadata", "train", tsv), nb_files=cfg.data.nb_files)]
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": len(unique(r["filename"] for r in rows))}
    scaler = Scaler()
    scaler_path = osp.join(cfg.data.exp_root, cfg.data.dataset_name + ".json")
    t0 = time.perf_counter()
    if osp.isfile(scaler_path):
        scaler.load(scaler_path)
    else:
        pre = DataLoadDf(rows, transform=get_transforms(cfg.model.max_frames, None,
                                                        compute_log=True))
        scaler.calculate_scaler(pre.features_only(i)[0] for i in range(len(pre)))
        os.makedirs(osp.dirname(scaler_path), exist_ok=True)
        scaler.save(scaler_path)
    timings["scaler_s"] = time.perf_counter() - t0
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
    generator from a periodic checkpoint and goes on at the next epoch.
    """
    dev = resolve_device(device)
    _check_ported(args)
    cfg = spsedt_config(args)
    if args.log:
        set_logger(cfg.train.info)
    log = create_logger("train_spsedt_torch")
    log.info("SP-SEDT self-supervised pretraining (PyTorch)")
    rng = np.random.RandomState(cfg.train.seed)
    epochs: List[Dict] = []

    model_dir = osp.join(cfg.data.exp_root, cfg.data.dataset_name, "model")
    os.makedirs(model_dir, exist_ok=True)
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
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    start_epoch = 0
    if args.resume:
        ck = load_checkpoint(osp.join(model_dir, args.resume))
        model.load_state_dict(ck["model"])
        start_epoch = int(ck.get("epoch", -1)) + 1
        if "optimizer" in ck:
            state.optimizer.load_state_dict(ck["optimizer"])
            _set_rng_state(rng, ck["rng"])
            gen.set_state(ck["generator"])
        log.info(f"resumed from {args.resume}: epoch {start_epoch} next")

    train_step = make_train_step(model, weight_dict, cfg, state.optimizer, augment_on=False,
                                 device=dev)
    bank = maybe_bank(args, train_data, cfg, dev, log=log)

    def save(name: str, content: Dict, record: Dict) -> None:
        t = time.perf_counter()
        save_checkpoint(osp.join(model_dir, name), content)
        record["checkpoint_s"] = record.get("checkpoint_s", 0.0) + time.perf_counter() - t

    for epoch in range(start_epoch, args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0 = time.time()
        order = rng.permutation(len(train_data))
        index_batches = [order[b * bs:(b + 1) * bs].tolist() for b in range(len(order) // bs)]
        acc, timer = train_one_epoch(train_step, train_data, index_batches, cfg, bank, gen, log)
        means, n_steps = acc.means()  # the one fetch of the epoch
        train_s = time.time() - t0
        loss_mean = float(means.get("loss", float("nan")))
        log.info(f"Epoch {epoch}: loss {loss_mean:.4f} ({n_steps} steps, {train_s:.1f}s) "
                 f"{timer.summary()}")
        record.update(loss=loss_mean, loss_means=means, steps=n_steps, train_s=train_s,
                      data_wait_s=timer.data_time.sum)
        if not math.isfinite(loss_mean):
            log.info("Loss is not finite, stopping")
            raise SystemExit(1)
        if cfg.train.checkpoint_epochs and (epoch + 1) % cfg.train.checkpoint_epochs == 0:
            save(f"{cfg.train.info}_{epoch}", {
                "model": model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "epoch": epoch, "rng": _rng_state(rng), "generator": gen.get_state()}, record)
    final = {}
    save(cfg.train.info, {"model": model.state_dict(), "epoch": args.epochs}, final)
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
        classes = list(cfg.data.classes)
        enc = BoxEncoder(classes, seconds=cfg.features.max_len_seconds)
        mk = lambda n, seed, **kw: SyntheticDataset(
            n, classes, cfg.model.max_frames, cfg.model.n_mels, enc.encode_strong_df,
            max_events=min(3, cfg.model.max_events), seconds=cfg.features.max_len_seconds,
            seed=seed, **kw)
        n_strong = max(args.smoke_clips // 4, 4 * batch_sizes[0])
        n_weak = max(args.smoke_clips // 4, 4 * batch_sizes[1])
        n_unlab = max(args.smoke_clips // 2, 4 * batch_sizes[2])
        valid = mk(max(16, args.smoke_clips // 4), 1)
        return {"train": ConcatDataset([mk(n_strong, 0), mk(n_weak, 2, weak_only=True),
                                        mk(n_unlab, 5, unlabel=True)]),
                "validation": valid, "eval": valid, "encoder": enc,
                "ref_valid": valid.ref_rows(), "ref_eval": valid.ref_rows(), "timings": {}}
    data = build_real_data(cfg, args)
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    ds = SedData(cfg.data.dataset_name, base_feature_dir=osp.join(root, "features"),
                 compute_log=False)
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
    the metrics and pseudo counts summed on the device and fetched once, the
    thresholds adapted from the counts (uploaded once for the next epoch),
    the teacher's (``--teacher_eval``, the default) or the student's
    validation with a best checkpoint per fusion strategy (student, teacher,
    epoch) and early stopping, and every ``checkpoint_epochs`` a periodic
    checkpoint with AdamW, the thresholds, the policies, the sampler's
    stream and the step's generator, from which ``--resume`` goes on at the
    next epoch as the uninterrupted run does.  Then the final test of each
    strategy's best teacher (or student) on validation and eval.
    """
    dev = resolve_device(device)
    _check_ported(args)
    if getattr(args, "from_wavs", False):
        raise ValueError("--from_wavs streams waveforms to the supervised trainer only")
    if not (args.teacher_model or args.synthetic_smoke or args.eval):
        raise SystemExit("please provide the teacher model (--teacher_model)")
    cfg = args_to_config(args)
    if args.log:
        set_logger(cfg.train.info)
    log = create_logger("train_ss_sedt_torch")
    log.info("Semi-supervised SEDT, mean teacher (PyTorch)")
    np.random.seed(cfg.train.seed)
    epochs: List[Dict] = []
    final: List[Dict] = []
    nc = cfg.model.num_classes

    model_dir = osp.join(cfg.data.exp_root, cfg.data.dataset_name, "model")
    os.makedirs(model_dir, exist_ok=True)
    bs = args.semi_batch_size
    batch_sizes = [bs // 4, bs // 4, 2 * bs // 4]
    data = build_semi_data(cfg, args, batch_sizes)
    enc, concat = data["encoder"], data["train"]
    sampler = MultiStreamBatchSampler(concat, batch_sizes, seed=cfg.train.seed)
    steps_per_epoch = max(len(sampler), 1)

    model, weight_dict = init_model(cfg, dev)
    if args.teacher_model:
        model.load_state_dict(load_checkpoint(osp.join(model_dir, args.teacher_model))["model"])
        log.info(f"using teacher model: {args.teacher_model}")
    state = init_train_state(model, cfg, steps_per_epoch, schedule="cosine")
    teacher = make_teacher(model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    prior = np.asarray(C.DCASE_CLASS_PRIOR[:nc], np.float64)
    prior = prior / prior.sum()
    origin_threshold = np.full((nc,), 0.5)
    thresholds = origin_threshold.copy()
    best_saver = {m: SaveBest("sup") for m in cfg.train.fusion_strategy}
    early = EarlyStopping(patience=cfg.train.early_stopping_patience,
                          init_patience=cfg.train.early_stopping_init_wait,
                          fusion_strategy=cfg.train.fusion_strategy)
    start_epoch = 0
    if args.resume:
        ck = load_checkpoint(osp.join(model_dir, args.resume))
        model.load_state_dict(ck["model"])
        teacher.load_state_dict(ck["teacher"])
        start_epoch = int(ck.get("epoch", -1)) + 1
        if "optimizer" in ck:
            state.optimizer.load_state_dict(ck["optimizer"])
            _set_rng_state(sampler.rng, ck["sampler"])
            gen.set_state(ck["generator"])
            thresholds = ck["classwise_threshold"].numpy()
            for m, sd in ck["save_best"].items():
                best_saver[m].load_state_dict(sd)
            early.load_state_dict(ck["early"])
        log.info(f"resumed from {args.resume}: epoch {start_epoch} next")

    semi_step = make_semi_train_step(weight_dict, cfg, fine_tune=cfg.train.fine_tune,
                                     normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                                     n_labeled=batch_sizes[0] + batch_sizes[1], device=dev)
    eval_steps = {"teacher": make_eval_step(teacher, weight_dict, cfg, cfg.train.fusion_strategy,
                                            device=dev),
                  "student": make_eval_step(model, weight_dict, cfg, cfg.train.fusion_strategy,
                                            device=dev)}
    evaluated = "teacher" if args.teacher_eval else "student"
    # the fixed batch layout's flags by position (the strong stream's rows
    # are strong whether or not they hold events)
    pos = torch.arange(bs)
    flags = [f.to(dev) for f in (pos < batch_sizes[0], (pos >= batch_sizes[0])
                                 & (pos < batch_sizes[0] + batch_sizes[1]),
                                 pos >= batch_sizes[0] + batch_sizes[1])]
    train_bank = maybe_bank(args, concat, cfg, dev, log=log)
    valid_bank = maybe_bank(args, data["validation"], cfg, dev, log=log)
    eval_bank = (valid_bank if data["eval"] is data["validation"]
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

    def save(name: str, content: Dict, record: Dict) -> None:
        t = time.perf_counter()
        save_checkpoint(osp.join(model_dir, name), content)
        record["checkpoint_s"] = record.get("checkpoint_s", 0.0) + time.perf_counter() - t

    semi_weights = ({f"sup_{k}": v for k, v in weight_dict.items()}
                    | {f"unsup_{k}": v for k, v in weight_dict.items()})
    metrics: Dict[int, float] = {}
    for epoch in range(start_epoch, args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0 = time.time()
        mlog = MetricLogger(delimiter="  ")
        # the thresholds go to the device once an epoch, compared in f32
        threshold_dev = torch.as_tensor(thresholds, dtype=torch.float32).to(dev)
        acc, timer = train_one_epoch(epoch_step(threshold_dev), concat, sampler, cfg, train_bank,
                                     gen, log)
        totals = acc.totals()  # the one fetch of the epoch
        n_steps = acc.steps
        train_s = time.time() - t0
        counts = totals.pop("pseudo_counts", np.zeros(nc))
        means = {k: float(v) / max(n_steps, 1) for k, v in totals.items()}
        loss_mean = means.pop("loss", float("nan"))
        get_reduced_loss(means, semi_weights, mlog)
        mlog.update(loss=loss_mean)
        thresholds = adjust_threshold(counts, origin_threshold, prior)
        mlog.synchronize_between_processes()
        log.info(f"Epoch {epoch}: loss {loss_mean:.4f} ({n_steps} steps, {train_s:.1f}s) "
                 f"{timer.summary()}; pseudo counts {counts.astype(int).tolist()}")
        log.info("Train averaged stats:\n" + str(mlog))
        record.update(loss=loss_mean, loss_means=dict(means, loss=loss_mean), steps=n_steps,
                      train_s=train_s, data_wait_s=timer.data_time.sum,
                      pseudo_counts=counts.tolist(), thresholds=thresholds.tolist())
        if not math.isfinite(loss_mean):
            log.info(f"Loss is {loss_mean}, stopping training")
            raise SystemExit(1)

        log.info(f"{evaluated} model validation")
        res = evaluate(eval_steps[evaluated], data["validation"], cfg, enc, data["ref_valid"],
                       cfg.train.fusion_strategy, at=cfg.model.dec_at, weight_dict=weight_dict,
                       bank=valid_bank)
        metrics = res.f1
        record.update(val_loss_means=res.loss_means, val_f1=dict(metrics),
                      eval_timings=res.timings)
        stop = False
        for m, f1 in metrics.items():
            if best_saver[m].apply(f1):
                save(f"{cfg.train.info}_{m}_best", {
                    "model": model.state_dict(), "teacher": teacher.state_dict(),
                    "epoch": epoch, f"event_based_f1_{m}": f1}, record)
            if early.apply(f1):
                log.warning("EARLY STOPPING")
                stop = True
        if cfg.train.checkpoint_epochs and (epoch + 1) % cfg.train.checkpoint_epochs == 0:
            save(f"{cfg.train.info}_{epoch}", {
                "model": model.state_dict(), "teacher": teacher.state_dict(),
                "optimizer": state.optimizer.state_dict(), "epoch": epoch,
                "classwise_threshold": torch.from_numpy(np.asarray(thresholds, np.float64)),
                "sampler": _rng_state(sampler.rng), "generator": gen.get_state(),
                "save_best": {m: s.state_dict() for m, s in best_saver.items()},
                "early": early.state_dict()}, record)
        if stop:
            break

    # the final test of each strategy's best teacher (or student); without a
    # best checkpoint the model last loaded is tested, the student at first
    tested, tested_step = "student", eval_steps["student"]
    for m in cfg.train.fusion_strategy:
        record = {"fusion_strategy": m}
        final.append(record)
        best_path = osp.join(model_dir, f"{cfg.train.info}_{m}_best")
        if osp.exists(best_path):
            t = time.perf_counter()
            ck = load_checkpoint(best_path)
            (teacher if args.teacher_eval else model).load_state_dict(
                ck["teacher" if args.teacher_eval else "model"])
            tested, tested_step = evaluated, eval_steps[evaluated]
            record.update(checkpoint_s=time.perf_counter() - t, loaded=best_path)
            log.info(f"using the {tested} for the test")
        record["model"] = tested
        log.info("Metric on validation")
        res = evaluate(tested_step, data["validation"], cfg, enc, data["ref_valid"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True, bank=valid_bank)
        record.update(valid_f1=res.f1[m], valid_timings=res.timings)
        log.info("Metric on eval")
        res = evaluate(tested_step, data["eval"], cfg, enc, data["ref_eval"], [m],
                       at=cfg.model.dec_at, cal_seg=True, cal_clip=True, bank=eval_bank)
        metrics = res.f1
        record.update(eval_f1=metrics[m], eval_timings=res.timings)
    return TrainResult(metrics, epochs, final,
                       bank=train_bank is not None and valid_bank is not None,
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
    root = osp.join(cfg.data.root, cfg.data.dataset_name)
    ds = SedData(cfg.data.dataset_name, base_feature_dir=osp.join(root, "features"),
                 compute_log=False)
    paths, audio_dirs = real_data_paths(cfg)
    paths.pop("eval")
    train_keys = ["train"] if "train" in paths else ["weak", "synthetic"]
    t0 = time.perf_counter()
    dfs = get_dfs(ds, paths, nb_files=cfg.data.nb_files, audio_dirs=audio_dirs)
    timings = {"features_s": time.perf_counter() - t0, "extracted": ds.n_extracted,
               "clips": sum(len(unique(r["filename"] for r in rows)) for rows in dfs.values())}
    scaler = Scaler()
    scaler_path = osp.join(cfg.data.exp_root, cfg.data.dataset_name + "_at.json")
    t0 = time.perf_counter()
    if osp.isfile(scaler_path):
        scaler.load(scaler_path)
    else:
        pre = ConcatDataset([DataLoadDf(dfs[k], transform=get_frame_transforms(
            m.max_frames, None, compute_log=True)) for k in train_keys])
        scaler.calculate_scaler(pre.features_only(i)[0] for i in range(len(pre)))
        os.makedirs(osp.dirname(scaler_path), exist_ok=True)
        scaler.save(scaler_path)
    timings["scaler_s"] = time.perf_counter() - t0
    tf = get_frame_transforms(m.max_frames, scaler, compute_log=True)
    cache = cfg.data.in_memory
    train = ConcatDataset([DataLoadDf(dfs[k], mhe.encode_weak, tf, in_memory=cache,
                                      cache_transformed=cache) for k in train_keys])
    valid = DataLoadDf(dfs["validation"], mhe.encode_weak, tf, cache_transformed=cache)
    return {"train": train, "validation": valid, "ref_valid": ref_rows(dfs["validation"]),
            "encoder": mhe, "timings": timings}


def init_audio_tag_model(cfg: SEDTConfig, pooling: str, device: torch.device) -> AudioTagBackbone:
    """The audio-tag model to train (logits out): parameters drawn on the CPU
    from ``cfg.train.seed``, then moved to ``device``."""
    m = cfg.model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = AudioTagBackbone(m.backbone, m.dilation, pooling, len(cfg.data.classes),
                                 logits_out=True)
    return model.to(device).eval()


def make_audio_tag_step(model: AudioTagBackbone, optimizer: SEDTOptimizer):
    """One audio-tag update on a batch already on the model's device
    (features [B, T, F, 1], multi-hot labels [B, C]): the BCE on the logits,
    averaged over B x C, its backward, the clip and Adam.  Returns the loss
    on the device (not fetched).  It computes in f32, as the JAX package's
    ``AudioTagBackbone`` does whatever ``--compute_dtype`` says."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = F.binary_cross_entropy_with_logits(model(x), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def audio_tag_rows(model: AudioTagBackbone, dataset, encoder: ManyHotEncoder, batch_size: int,
                   device: torch.device) -> List[Tuple]:
    """The tags of every clip of ``dataset`` (sigmoid > 0.5), in order at
    ``batch_size`` with a ragged last batch, as metric rows ``(filename, 0,
    0, label)``."""
    n = len(dataset)
    index_batches = [list(range(b, min(b + batch_size, n))) for b in range(0, n, batch_size)]
    rows: List[Tuple] = []
    for idxs, (x, _) in zip(index_batches, weak_batches(dataset, index_batches,
                                                        pin_memory=device.type == "cuda")):
        tags = (torch.sigmoid(model(x.to(device, non_blocking=True))) > 0.5).cpu().numpy()
        for i, row in zip(idxs, tags):
            rows.extend((dataset.filenames[i], 0.0, 0.0, lbl)
                        for lbl in encoder.decode_weak(row.astype(int)))
    return rows


def run_audio_tag(args, device: Optional[torch.device | str] = None) -> AudioTagResult:
    """The audio-tag backbone trainer, on ``--synthetic_smoke`` clips or the
    dataset under ``--data_root`` (``build_audio_tag_data``), returning the
    last validation's clip macro F1 and what the run measured.

    Runs on ``device`` (the GPU when None).  The model is
    ``AudioTagBackbone`` at ``--backbone``, ``--dilation`` and ``--pooling``
    (avg when unset), from an ImageNet backbone when one is named or
    present.  Each update: the BCE on the logits, then the clip of the
    global norm at 0.1 over every parameter (nothing is frozen) and Adam at
    ``--lr``, times 0.1 every ``--lr_drop`` epochs; f32, without autocast.
    Per epoch: one permutation from a ``RandomState(seed)`` (the JAX
    package's draw from numpy's seeded global stream), its full batches (the
    ragged tail dropped) built on the prefetch thread, the loss summed on
    the device and fetched once; a non-finite mean ends the run with
    ``SystemExit(1)``; then the clip tags of the validation set and their
    macro F1, and on a new best F1 the checkpoint ``{"model", "epoch"}`` at
    ``<exp_root>/<dataset>/model/at_<pooling>_<dataset>``.
    """
    dev = resolve_device(device)
    _check_ported(args)
    cfg = args_to_config(args)
    if args.log:
        set_logger(cfg.train.info)
    log = create_logger("train_at_torch")
    log.info("Audio-tag backbone trainer (PyTorch)")
    rng = np.random.RandomState(cfg.train.seed)
    pooling = args.pooling or "avg"
    epochs: List[Dict] = []

    model_dir = osp.join(cfg.data.exp_root, cfg.data.dataset_name, "model")
    os.makedirs(model_dir, exist_ok=True)
    data = build_audio_tag_data(cfg, args)
    train_data, valid, mhe = data["train"], data["validation"], data["encoder"]
    bs = cfg.data.batch_size
    model = init_audio_tag_model(cfg, pooling, dev)
    _imagenet_backbone_init(model, args, log)
    log.info(f"params: {sum(p.numel() for p in model.parameters())}")
    optimizer = make_audio_tag_optimizer(model, args.lr, args.lr_drop,
                                         max(len(train_data) // bs, 1), AT_CLIP_MAX_NORM)
    step = make_audio_tag_step(model, optimizer)
    pin = dev.type == "cuda"
    best = SaveBest("sup")
    model_path = osp.join(model_dir, f"at_{pooling}_{cfg.data.dataset_name}")
    f1 = 0.0
    for epoch in range(args.epochs):
        record: Dict = {"epoch": epoch}
        epochs.append(record)
        t0 = time.time()
        order = rng.permutation(len(train_data))
        index_batches = [order[b * bs:(b + 1) * bs].tolist() for b in range(len(order) // bs)]
        acc = DeviceMetricAccumulator()
        timer = StepTimer()  # its data_time: the wait for each batch
        for x, y in weak_batches(train_data, index_batches, pin_memory=pin):
            timer.data_loaded()
            acc.update({"loss": step(x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))})
            timer.step_done()
        means, n_steps = acc.means()  # the one fetch of the epoch
        train_s = time.time() - t0
        loss_mean = float(means.get("loss", float("nan")))
        log.info(f"Epoch {epoch}: loss {loss_mean:.4f} ({n_steps} steps, {train_s:.1f}s) "
                 f"{timer.summary()}")
        record.update(loss=loss_mean, steps=n_steps, train_s=train_s,
                      data_wait_s=timer.data_time.sum)
        if n_steps and not math.isfinite(loss_mean):
            log.info("Loss is not finite, stopping training")
            raise SystemExit(1)

        t0 = time.perf_counter()
        rows = audio_tag_rows(model, valid, mhe, bs, dev)
        f1 = audio_tagging_results(data["ref_valid"], rows)["avg"][0]
        record.update(val_s=time.perf_counter() - t0, f1=f1)
        log.info(f"AT clip macro F1: {f1:.4f}")
        if best.apply(f1):
            t0 = time.perf_counter()
            save_checkpoint(model_path, {"model": model.state_dict(), "epoch": epoch})
            record["checkpoint_s"] = time.perf_counter() - t0
    log.info(f"best AT model saved at {model_path}")
    return AudioTagResult(f1, epochs, model_dir=model_dir, checkpoint=model_path,
                          data_timings=data["timings"])
