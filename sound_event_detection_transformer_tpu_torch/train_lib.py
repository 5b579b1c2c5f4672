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
  step), returning a :class:`TrainResult`.

``--pretrain`` and several processes raise ``NotImplementedError``, naming
the ROADMAP item that brings them.  The SP-SEDT, semi-supervised and
audio-tag trainers wait for their slices.
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

from . import config as C
from .config import SEDTConfig
from .data.dataset import ConcatDataset, DataLoadDf, MultiStreamBatchSampler, WavLoadDf, batch_iterator
from .data.encoder import BoxEncoder
from .data.feature_bank import maybe_bank
from .data.features import SedData, get_dfs
from .data.scaler import Scaler
from .data.synthetic import SyntheticDataset
from .data.transforms import get_transforms
from .data.tsv import unique
from .engine import init_train_state, make_eval_step, make_train_step
from .metrics import PSDSEval, audio_tagging_results, compute_metrics, format_audio_tagging, psds_score
from .models import build_model, resolve_device
from .models.torch_import import load_imagenet_backbone
from .ops.frontend import make_frontend_fn
from .parallel.distribute import get_reduced_loss, get_world_size
from .utils.checkpoint import EarlyStopping, SaveBest, back_up_code, load_checkpoint, save_checkpoint
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
    """What :func:`run_supervised` measured."""

    f1: Dict[int, float]  # the final test's F1 on eval, last strategy (as the JAX package)
    # per epoch: train loss means, lr, steps, seconds and the wait for
    # batches; with an evaluation its loss means, F1 and timings; the
    # checkpoint seconds
    epochs: List[Dict]
    final: List[Dict]  # per strategy of the final test: F1, PSDS and timings
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
    """Raise for the paths of the trainer that this port does not have yet."""
    if args.pretrain:
        raise NotImplementedError("--pretrain waits for SP-SEDT (ROADMAP queue 1, item 4)")
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
    """One pass of ``sampler`` over ``dataset`` through ``train_step``; returns
    the metrics summed on the device (a :class:`DeviceMetricAccumulator`,
    not yet fetched) and the step timer.  Batches are pinned for the card,
    and with ``bank`` their features are gathered there."""
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
