"""A seeded wav dataset on disk, in the URBAN-SED or the DCASE layout.

The port's counterpart of the repository's ``tools/make_wav_dataset.py``,
with ``csv`` in place of pandas: for the same seed and arguments it writes
the same wav bytes and the same TSV rows.  It drives the on-disk path (TSVs
-> ``SedData`` feature extraction -> ``.npy`` cache -> scaler ->
``DataLoadDf``) on a machine with no dataset, no pandas and no network.

URBAN-SED (44.1 kHz int16)::

    <root>/urbansed/audio/{train,validate,test}/<split>_clip_<i>.wav
    <root>/urbansed/metadata/{train,validate,test}.tsv

DCASE (16 kHz): strong labels in ``metadata/train/synthetic_2019/soundscapes.tsv``,
clip tags (``event_labels``, comma-joined) in ``metadata/train/weak.tsv``,
file names only in ``metadata/train/unlabel_in_domain.tsv``, validation
audio directly under ``audio/validation``, the eval set in
``metadata/eval/public.tsv``.

Each clip is a noise floor plus 1-3 class-specific tone stacks (fundamental
220 (c + 1) Hz and harmonics, 10 ms attack and release) at known onsets and
offsets.  Usage::

    python -m sound_event_detection_transformer_tpu_torch.data.wav_dataset \\
        --root ./data --train 2048 --validate 512 --test 512 [--seed 0]
    python -m sound_event_detection_transformer_tpu_torch.data.wav_dataset \\
        --root ./datadc --dataname dcase --strong 2048 --weak 2048 --unlabel 8192
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ..config import DCASE_CLASSES, URBAN_CLASSES
from .tsv import write_tsv

SR = 44100
SECONDS = 10.0

# Parameter domains of the generator.  'legacy' is the original fixed
# generator; 'restricted' a narrow slice (loud, long, one timbre, a fixed
# noise floor); 'full' the space it is drawn from (quieter and shorter
# events, three timbres, +/-2 % detune, a varying noise floor).  With
# --headroom the DCASE layout labels the restricted slice and leaves the full
# space weak or unlabeled, as DCASE2019's synthetic-strong and real-unlabeled
# sets differ.
TIMBRES = {
    "A": ((1, 1.0), (2, 0.5), (3, 0.25)),
    "B": ((1, 1.0), (2, 0.15), (3, 0.6), (4, 0.3)),
    "C": ((1, 1.0), (3, 0.33), (5, 0.2)),
}
DOMAINS = {
    "legacy": dict(amp=(0.7, 1.3), dur=(0.8, 3.5), noise=(0.03, 0.03),
                   timbres="A", detune=0.0),
    "restricted": dict(amp=(0.9, 1.3), dur=(1.6, 3.5), noise=(0.03, 0.03),
                       timbres="A", detune=0.0),
    "full": dict(amp=(0.35, 1.3), dur=(0.7, 3.5), noise=(0.02, 0.05),
                 timbres="ABC", detune=0.02),
}
COLUMNS = {
    "strong": ("filename", "onset", "offset", "event_label"),
    "weak": ("filename", "event_labels"),
    "unlabel": ("filename",),
}


def synth_clip(rng: np.random.RandomState, n_classes: int, max_events: int = 3,
               min_events: int = 1, sr: int = SR, domain: str = "legacy"):
    """One 10 s waveform and its events [(class index, onset_s, offset_s)]."""
    dom = DOMAINS[domain]
    n = int(sr * SECONDS)
    # a fixed range takes no draw, so 'legacy' keeps the original stream
    lo, hi = dom["noise"]
    y = rng.randn(n).astype(np.float32) * (lo if lo == hi else rng.uniform(lo, hi))
    events = []
    for _ in range(rng.randint(min_events, max_events + 1)):
        ci = rng.randint(n_classes)
        dur = rng.uniform(*dom["dur"])  # seconds
        on = rng.uniform(0.0, SECONDS - dur)
        t = np.arange(int(dur * sr)) / sr
        f0 = 220.0 * (ci + 1)
        if dom["detune"]:
            f0 *= rng.uniform(1.0 - dom["detune"], 1.0 + dom["detune"])
        fam = dom["timbres"]
        fam = fam if len(fam) == 1 else fam[rng.randint(len(fam))]
        burst = np.zeros_like(t, np.float32)
        for h, amp in TIMBRES[fam]:
            burst += amp * np.sin(2 * np.pi * f0 * h * t).astype(np.float32)
        # 10 ms linear attack and release, so the band edge is not a click
        env = np.minimum(1.0, np.minimum(t, dur - t) / 0.01).astype(np.float32)
        burst *= 0.2 * env * rng.uniform(*dom["amp"])
        i0 = int(on * sr)
        y[i0:i0 + len(t)] += burst
        events.append((ci, on, on + dur))
    return y, events


def write_split(root: str, split: str, n_clips: int, classes: Sequence[str], seed: int,
                sr: int = SR, audio_sub: Optional[str] = None, tsv_path: Optional[str] = None,
                label_mode: str = "strong", domain: str = "legacy") -> None:
    """One split: wavs under ``<root>/audio/<audio_sub or split>`` and its TSV
    (``<root>/metadata/<split>.tsv`` unless ``tsv_path``).  ``label_mode``:
    'strong' rows (filename, onset, offset, event_label), 'weak' rows
    (filename, event_labels) or 'unlabel' rows (filename)."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    adir = osp.join(root, "audio", audio_sub or split)
    os.makedirs(adir, exist_ok=True)
    rows = []
    for i in range(n_clips):
        fname = f"{split}_clip_{i}.wav"
        y, events = synth_clip(rng, len(classes), sr=sr, domain=domain)
        wavfile.write(osp.join(adir, fname), sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))
        if label_mode == "strong":
            rows.extend((fname, round(on, 3), round(off, 3), classes[ci])
                        for ci, on, off in events)
        elif label_mode == "weak":
            rows.append((fname, ",".join(sorted({classes[ci] for ci, _, _ in events}))))
        else:
            rows.append((fname,))
        if (i + 1) % 512 == 0:
            print(f"  {split}: {i + 1}/{n_clips}", flush=True)
    write_tsv(tsv_path or osp.join(root, "metadata", f"{split}.tsv"), COLUMNS[label_mode], rows)
    print(f"{split}: {n_clips} clips, {len(rows)} rows ({label_mode}, {domain})")


def write_urbansed(root: str, train: int, validate: int, test: int, num_classes: int = 10,
                   seed: int = 0) -> str:
    """The URBAN-SED layout under ``<root>/urbansed`` (returned); the splits
    take seeds ``seed``, ``seed + 1`` and ``seed + 2``."""
    classes = URBAN_CLASSES[:num_classes]
    root = osp.join(root, "urbansed")
    write_split(root, "train", train, classes, seed)
    write_split(root, "validate", validate, classes, seed + 1)
    write_split(root, "test", test, classes, seed + 2)
    return root


def write_dcase(root: str, strong: int, weak: int, unlabel: int, validate: int, test: int,
                num_classes: int = 10, seed: int = 0, headroom: bool = False) -> str:
    """The DCASE layout under ``<root>/dcase`` (returned), at 16 kHz; with
    ``headroom`` the strong split comes from the restricted domain and every
    other split from the full one."""
    classes = DCASE_CLASSES[:num_classes]
    root = osp.join(root, "dcase")
    sr = 16000
    d_strong = "restricted" if headroom else "legacy"
    d_wild = "full" if headroom else "legacy"
    meta = lambda *p: osp.join(root, "metadata", *p)
    write_split(root, "synthetic", strong, classes, seed, sr=sr,
                audio_sub=osp.join("train", "synthetic_2019", "soundscapes"),
                tsv_path=meta("train", "synthetic_2019", "soundscapes.tsv"), domain=d_strong)
    write_split(root, "weak", weak, classes, seed + 3, sr=sr,
                audio_sub=osp.join("train", "weak"), tsv_path=meta("train", "weak.tsv"),
                label_mode="weak", domain=d_wild)
    write_split(root, "unlabel", unlabel, classes, seed + 4, sr=sr,
                audio_sub=osp.join("train", "unlabel_in_domain"),
                tsv_path=meta("train", "unlabel_in_domain.tsv"), label_mode="unlabel",
                domain=d_wild)
    write_split(root, "validation", validate, classes, seed + 1, sr=sr, audio_sub="validation",
                tsv_path=meta("validation", "validation.tsv"), domain=d_wild)
    write_split(root, "public", test, classes, seed + 2, sr=sr,
                audio_sub=osp.join("eval", "public"), tsv_path=meta("eval", "public.tsv"),
                domain=d_wild)
    return root


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="./data")
    ap.add_argument("--dataname", default="urbansed", choices=["urbansed", "dcase"])
    ap.add_argument("--train", default=2048, type=int, help="urbansed strong train")
    ap.add_argument("--strong", default=2048, type=int, help="dcase synthetic_2019")
    ap.add_argument("--weak", default=2048, type=int)
    ap.add_argument("--unlabel", default=8192, type=int)
    ap.add_argument("--validate", default=512, type=int)
    ap.add_argument("--test", default=512, type=int)
    ap.add_argument("--num_classes", default=10, type=int)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--headroom", action="store_true",
                    help="dcase only: strong labels from the restricted domain, every "
                         "other split from the full one")
    args = ap.parse_args(argv)
    if args.dataname == "urbansed":
        write_urbansed(args.root, args.train, args.validate, args.test, args.num_classes,
                       args.seed)
    else:
        write_dcase(args.root, args.strong, args.weak, args.unlabel, args.validate, args.test,
                    args.num_classes, args.seed, args.headroom)


if __name__ == "__main__":
    main()
