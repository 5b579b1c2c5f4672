"""The readings that the audio-tag and predict cells' limits are set from, on
the card at the cell's own size, several seeds in one process; the
benchmark's runs never call it.

    python benchmark/control_cells.py --workload ast-audioset.tag-b64 --seeds 1 2 3 \\
        --what program control unchanged half_batch
    python benchmark/control_cells.py --workload sedt-urbansed.predict-b256 --seeds 1 2 3 \\
        --what program control unlogged half_batch

For each seed it reads, against the f32 reference on the same clips:

* ``program``: the program's check steps or batches as a run makes them (the
  lower readings);
* ``control``: the reference itself in the next precision below the
  configuration's, put in the program's place (the upper readings): AST in
  float8 (:mod:`benchmark.reference.model`'s rounding); the predict cell's
  frontend in bf16 (below its f32) and its network in float8 (below bf16);
* the program with a fault planted under the timed path (:data:`FAULTS`).

One JSON line a seed and kind, then each number's least and largest reading
per kind.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import control, harness  # noqa: E402
from benchmark import traffic as T  # noqa: E402


@contextlib.contextmanager
def half_tag_batch() -> Iterator[None]:
    """Every audio-tag step sees the first half of its batch only."""
    from sound_event_detection_transformer_tpu_torch import train_lib

    real = train_lib.make_audio_tag_step

    def make(*args, **kw):
        step = real(*args, **kw)
        return lambda x, y: step(x[:x.shape[0] // 2], y[:y.shape[0] // 2])

    train_lib.make_audio_tag_step = make
    try:
        yield
    finally:
        train_lib.make_audio_tag_step = real


@contextlib.contextmanager
def half_infer_batch() -> Iterator[None]:
    """Every inference call runs the first half of its batch only and hands
    the second half the first half's results."""
    from sound_event_detection_transformer_tpu_torch import predict_cli

    real = predict_cli.make_infer

    def make(*args, **kw):
        infer = real(*args, **kw)

        def half(waves):
            return tuple(torch.cat([t, t]) for t in infer(waves[:waves.shape[0] // 2]))

        half.device = infer.device
        return half

    predict_cli.make_infer = make
    try:
        yield
    finally:
        predict_cli.make_infer = real


@contextlib.contextmanager
def unlogged() -> Iterator[None]:
    """The frontend skips the decibel scale: mel magnitudes go to the model."""
    from sound_event_detection_transformer_tpu_torch import predict_cli

    real = predict_cli.make_frontend_fn
    predict_cli.make_frontend_fn = lambda **kw: real(**dict(kw, compute_log=False))
    try:
        yield
    finally:
        predict_cli.make_frontend_fn = real


FAULTS = {"tag_epoch": {"unchanged": control.unchanged, "half_batch": half_tag_batch},
          "predict": {"unlogged": unlogged, "half_batch": half_infer_batch}}


def tag_readings(config: Dict, traffic: Dict, seed: int, device: torch.device,
                 whats: List[str]) -> Iterator[Tuple[str, Dict]]:
    """``(what, its readings)`` of each of ``whats`` at ``seed``, against one
    f32 reference run on the seed's clips."""
    from benchmark import traffic_tag as TT
    from benchmark.entries import tag_epoch as E
    from benchmark.reference import ast as RA
    from benchmark.reference import check as ref_check

    seeds = T.sub_seeds(seed)
    m = RA.settings(config)
    clips = TT.make_tag_clips(config["train_clips"], m["frames"], m["n_mels"], m["num_classes"],
                              traffic, seeds, device)
    rows = T.check_batches(config["train_clips"], traffic, seeds)
    ref = RA.readings(config, clips, rows, seeds["weights"], device)
    for what in whats:
        if what == "control":
            got = RA.readings(config, clips, rows, seeds["weights"], device, mode="fp8")
        else:
            with FAULTS["tag_epoch"][what]() if what != "program" else contextlib.nullcontext():
                cell = E.Cell(config, traffic, seed, device)
                got = cell.check_steps()
            if cell.check_rows != rows or not np.array_equal(cell.clips.feats, clips.feats):
                raise RuntimeError("the program ran other clips than the reference")
            cell.release()
        yield what, ref_check.compare(got, ref)


def predict_readings(config: Dict, traffic: Dict, seed: int, device: torch.device,
                     whats: List[str]) -> Iterator[Tuple[str, Dict]]:
    """``(what, its readings)`` of each of ``whats`` at ``seed``, against one
    f32 reference run on the seed's first batch."""
    from benchmark import traffic_wave as TW
    from benchmark.entries import predict as E
    from benchmark.entries.train_epoch import program_config

    seeds = T.sub_seeds(seed)
    _, cfg = program_config(config, traffic, seeds)
    fc = cfg.features
    waves = TW.make_waves(traffic["clips"], fc.sample_rate, fc.max_len_seconds,
                          len(cfg.data.classes), traffic, seeds, device)
    first = TW.batch_rows(0, traffic["clips"], traffic["batch"])
    out = {"check_waves": waves.waves[first], "frontend": E.frontend_settings(cfg),
           "frames": cfg.model.max_frames}
    ref = E.reference(config, out, seed, device)
    for what in whats:
        if what == "control":
            got = E.reference(config, out, seed, device, mode="bf16", net_mode="fp8")
        else:
            with FAULTS["predict"][what]() if what != "program" else contextlib.nullcontext():
                cell = E.Cell(config, traffic, seed, device)
                got = cell.check_steps()
            if not np.array_equal(cell.waves.waves[first], out["check_waves"]):
                raise RuntimeError("the program ran other waves than the reference")
            cell.release()
        yield what, E.compare(got, ref)


READINGS = {"tag_epoch": tag_readings, "predict": predict_readings}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--what", nargs="+", default=["program", "control"])
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("control_cells.py reads the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    w = harness.load("workloads", a.workload)
    if w["entry"] not in READINGS:
        print(f"{a.workload}: benchmark/control.py reads the {w['entry']} cells", file=sys.stderr)
        return 2
    config, traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
    seen: Dict[str, Dict[str, list]] = {}
    for seed in a.seeds:
        for what, got in READINGS[w["entry"]](config, traffic, seed, device, a.what):
            print(json.dumps({"seed": seed, "what": what, **got}), flush=True)
            for k, v in got.items():
                seen.setdefault(what, {}).setdefault(k, []).append(v["value"])
    print(json.dumps({what: {k: {"least": min(v), "largest": max(v)} for k, v in nums.items()}
                      for what, nums in seen.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
