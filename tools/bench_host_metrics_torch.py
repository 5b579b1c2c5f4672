#!/usr/bin/env python3
"""Host-side metric benchmark of the PyTorch port: ``compute_metrics`` and
the 9-threshold PSDS sweep.

The port's counterpart of ``tools/bench_host_metrics.py``: it draws the same
synthetic evaluation from ``RandomState(0)``, the same draws in the same
order (``N`` = 2048 clips of 10 classes, 2 reference events and 5 scored
detections a clip, then the raw per-batch outputs of ``N / B`` batches of
``Q`` queries), keeps it as rows, not DataFrames, and times the two host
scoring paths at the end of every evaluation: the port's
``metrics.compute_metrics`` (event, segment and clip F1) and a PSDS sweep
over 9 decode thresholds (``BoxEncoder.decode_strong_batch``, then
``PSDSEval.add_operating_point`` and ``psds_score``).  It prints the JAX
tool's three timings.  Host work only: it needs no card and no pandas.

    python3 tools/bench_host_metrics_torch.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder  # noqa: E402
from sound_event_detection_transformer_tpu_torch.metrics import (  # noqa: E402
    PSDSEval,
    compute_metrics,
    psds_score,
)

CLASSES = [f"c{i}" for i in range(10)]
N, Q, B = 2048, 10, 64
THRESHOLDS = np.arange(0.1, 1.0, 0.1)


def synthetic_evaluation(n: int = N, q: int = Q, b: int = B) -> dict:
    """The JAX tool's draws: reference rows ``(filename, onset, offset,
    label)``, detections with a score, the metadata ``(filename, 10.0)``,
    and the per-batch ``(scores, labels, boxes, row ids)``."""
    rng = np.random.RandomState(0)
    ref = []
    for i in range(n):
        for _ in range(2):
            o = rng.uniform(0, 8)
            ref.append((f"f{i}.wav", o, o + rng.uniform(0.3, 2), CLASSES[rng.randint(10)]))
    pred = []
    for i in range(n):
        for _ in range(5):
            o = rng.uniform(0, 9)
            pred.append((f"f{i}.wav", o, o + rng.uniform(0.1, 3), CLASSES[rng.randint(10)],
                         rng.rand()))
    batches = []
    for s in range(0, n, b):
        scores = rng.beta(0.7, 3.0, (b, q)).astype(np.float32)
        labels = rng.randint(0, 10, (b, q))
        on = rng.uniform(0, 9, (b, q))
        dur = rng.uniform(0.05, 3, (b, q))
        boxes = np.stack([on, np.minimum(on + dur, 10.0)], -1).astype(np.float32)
        batches.append((scores, labels, boxes, np.arange(s, s + b)))
    meta = [(f, 10.0) for f in dict.fromkeys(r[0] for r in ref)]
    return {"ref": ref, "pred": pred, "meta": meta, "batches": batches,
            "filenames": [f"f{i}.wav" for i in range(n)]}


def decode_rows(ev: dict, enc: BoxEncoder, thr: float) -> list:
    """One operating point: every batch decoded at ``thr``, as metric rows."""
    rows = []
    for scores, labels, boxes, idxs in ev["batches"]:
        for j, events in enc.decode_strong_batch(scores, labels, boxes, threshold=thr).items():
            for lbl, on, off, _ in events:
                rows.append((ev["filenames"][idxs[j]], float(np.clip(on, 0, 10)),
                             float(np.clip(off, 0, 10)), lbl))
    return rows


def run(n: int = N) -> dict:
    """The benchmark on ``n`` clips: the F1 and the three PSDS scores, the
    operating points' rows and the timings in seconds."""
    ev = synthetic_evaluation(n)
    t0 = time.perf_counter()
    f1 = compute_metrics(ev["pred"], ev["ref"], cal_seg=True, cal_clip=True)
    metrics_s = time.perf_counter() - t0
    enc = BoxEncoder(CLASSES, seconds=10.0)
    psds = PSDSEval(ground_truth=ev["ref"], metadata=ev["meta"])
    ops, decode_s, match_s = [], 0.0, 0.0
    for thr in THRESHOLDS:
        t1 = time.perf_counter()
        ops.append(decode_rows(ev, enc, thr))
        t2 = time.perf_counter()
        psds.add_operating_point(ops[-1])
        decode_s += t2 - t1
        match_s += time.perf_counter() - t2
    t3 = time.perf_counter()
    scores = psds_score(psds)
    return {"f1": f1, "psds": scores, "ops": ops, "ev": ev,
            "seconds": {"compute_metrics": metrics_s, "decode": decode_s, "matching": match_s,
                        "score": time.perf_counter() - t3}}


def main() -> dict:
    res = run()
    s = res["seconds"]
    print(f"compute_metrics ({len(res['ev']['pred'])} dets, {N} clips): "
          f"{s['compute_metrics']:.2f}s")
    print(f"PSDS sweep: decode {s['decode']:.2f}s, matching {s['matching']:.2f}s, "
          f"score {s['score']:.2f}s")
    return res


if __name__ == "__main__":
    main()
