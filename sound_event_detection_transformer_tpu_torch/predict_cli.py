#!/usr/bin/env python
"""Inference CLI of the port: wav files -> detected-event TSV.

Counterpart of the JAX package's ``predict_cli.py``.  Loads a checkpoint
saved by ``utils.checkpoint.save_checkpoint``, runs the waveform -> log-mel ->
SEDT pipeline on the GPU, decodes events with the fusion strategy and the
min-duration/overlap rules, and writes a sed_eval-compatible TSV.

Example:
  python predict_torch.py --checkpoint exp/urbansed/model/best \\
    --dataname urbansed --wav_dir ./my_clips --out predictions.tsv --dec_at

``main`` runs on the current CUDA device and raises without one.
:func:`make_infer` builds the device pipeline alone, for callers that bring
their own waveforms; it and :func:`run` take ``device="cpu"`` for tests.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os.path as osp
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SEDTConfig
from .data.encoder import BoxEncoder
from .data.features import read_audio
from .data.scaler import Scaler
from .models import build_model, postprocess, resolve_device
from .ops.frontend import make_frontend_fn
from .train_lib import args_to_config, get_parser
from .utils.checkpoint import load_checkpoint

TSV_COLUMNS = ("filename", "onset", "offset", "event_label", "score")


def build_parser() -> argparse.ArgumentParser:
    parser = get_parser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out", default="predictions.tsv")
    parser.add_argument("--scaler", default="",
                        help="scaler json from training; defaults to the one "
                             "the trainer saved at <exp_root>/<dataname>.json "
                             "when present (pass 'none' to skip normalization)")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--at_m", type=int, default=1)
    return parser


def make_infer(
    cfg: SEDTConfig,
    model: torch.nn.Module,
    scaler: Optional[Scaler] = None,
    at_m: int = 1,
    device: Optional[torch.device | str] = None,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``infer(waves [B, n_samples]) -> (scores [B, Q], labels [B, Q],
    boxes [B, Q, 2] in seconds)``, tensors on ``device``: the frontend, the
    deterministic forward with nothing padded, the audio tags at 0.5 and the
    fusion post-processing.  ``waves`` may be a numpy array or a tensor on any
    device."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device != dev:
        raise ValueError(f"model is on {param.device}, infer on {dev}")
    fc = cfg.features
    frontend = make_frontend_fn(
        sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window,
        hop=fc.hop_size, n_mels=fc.n_mels, max_frames=cfg.model.max_frames,
        scaler_mean=None if scaler is None else scaler.mean_,
        scaler_std=None if scaler is None else scaler.std_,
        compute_log=fc.compute_log,
    )

    @torch.inference_mode()
    def infer(waves):
        feats = frontend(torch.as_tensor(waves).to(dev))
        pad = torch.zeros(feats.shape[:2], dtype=torch.bool, device=dev)
        out = model(feats, pad)
        tags = (out["at"] > 0.5).float() if "at" in out else None
        sizes = torch.full((feats.shape[0],), fc.max_len_seconds, device=dev)
        pp = postprocess(out, sizes, audio_tags=tags, at_m=at_m)
        return pp.scores, pp.labels, pp.boxes

    return infer


def predict_files(cfg: SEDTConfig, infer, wavs: Sequence[str], batch_size: int,
                  threshold: float) -> List[Tuple]:
    """Run ``infer`` over wav files in batches; returns the TSV's rows."""
    fc = cfg.features
    enc = BoxEncoder(list(cfg.data.classes), seconds=fc.max_len_seconds)
    n_samples = int(fc.max_len_seconds * fc.sample_rate)
    bs = max(1, batch_size)
    rows = []
    for i in range(0, len(wavs), bs):
        chunk = wavs[i:i + bs]
        # one batch shape throughout: the ragged tail is zero-padded
        batch = np.zeros((bs, n_samples), np.float32)
        for j, w in enumerate(chunk):
            audio, _ = read_audio(w, fc.sample_rate)
            n = min(len(audio), n_samples)
            batch[j, :n] = audio[:n]
        scores, labels, boxes = (t.cpu().numpy() for t in infer(batch))
        for j, w in enumerate(chunk):
            for lbl, on, off, sc in enc.decode_strong(
                {"scores": scores[j], "labels": labels[j], "boxes": boxes[j]},
                threshold=threshold,
            ):
                rows.append(
                    (osp.basename(w),
                     float(np.clip(on, 0, fc.max_len_seconds)),
                     float(np.clip(off, 0, fc.max_len_seconds)),
                     lbl, float(sc))
                )
    return rows


def write_tsv(rows: Sequence[Tuple], path: str) -> None:
    """Tab-separated, one header line, one event per row."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(TSV_COLUMNS)
        writer.writerows(rows)


def run(args: argparse.Namespace, device: Optional[torch.device | str] = None) -> int:
    """Everything after argument parsing; returns the number of events."""
    cfg = args_to_config(args)
    model, _ = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.checkpoint)["model"])

    # Default to the dataset scaler the trainer saved: predicting without the
    # training normalization silently degrades a trained checkpoint, so
    # discovery is automatic and opt-out.
    scaler_path = args.scaler
    if not scaler_path:
        cand = osp.join(cfg.data.exp_root, cfg.data.dataset_name + ".json")
        if osp.isfile(cand):
            scaler_path = cand
            print(f"using training scaler {cand}")
    scaler = None
    if scaler_path and scaler_path != "none":
        scaler = Scaler()
        scaler.load(scaler_path)

    infer = make_infer(cfg, model, scaler, args.at_m, device=device)
    wavs = sorted(glob.glob(osp.join(args.wav_dir, "*.wav")))
    if not wavs:
        raise FileNotFoundError(f"no wav files under {args.wav_dir}")
    rows = predict_files(cfg, infer, wavs, args.batch_size, args.threshold)
    write_tsv(rows, args.out)
    print(f"wrote {len(rows)} events for {len(wavs)} files to {args.out}")
    return len(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
