"""The readings that a cell's limits are set from, on the card at the cell's
own size, several seeds in one process; the benchmark's runs never call it.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 --what program control half_batch

For each seed it builds the cell's clips and weights and reads, against the
f32 reference's check steps:

* ``program``: the program's check steps as a run makes them (the lower
  readings);
* ``control``: the reference itself in the next precision below the
  configuration's bf16, float8 (:mod:`benchmark.reference.model`), put in
  the program's place (the upper readings);
* ``half_batch``, ``unchanged``: the program with a fault planted under the
  timed path (:data:`FAULTS`).

One JSON line a seed and kind, then each number's least and largest reading
per kind.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, Iterator

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.reference import check as ref_check  # noqa: E402


@contextlib.contextmanager
def unchanged() -> Iterator[None]:
    """Every optimizer step leaves the parameters and AdamW's state as they
    are (the gradients are dropped)."""
    from sound_event_detection_transformer_tpu_torch.parallel import optim

    real = optim.SEDTOptimizer.step

    def step(self):
        self.micro_steps += 1
        self.adamw.zero_grad(set_to_none=False)

    optim.SEDTOptimizer.step = step
    try:
        yield
    finally:
        optim.SEDTOptimizer.step = real


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    """Every train step sees the first half of its batch only, so its loss
    is the mean over that half."""
    from sound_event_detection_transformer_tpu_torch import engine

    real = engine.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def half(batch, generator):
            n = batch.feats.shape[0] // 2
            cut = lambda t: None if t is None else t[:n]
            b = batch._replace(feats=cut(batch.feats), pad_mask=cut(batch.pad_mask),
                               targets=type(batch.targets)(*(cut(t) for t in batch.targets)),
                               strong=cut(batch.strong), weak=cut(batch.weak),
                               indexes=cut(batch.indexes))
            return step(b, generator)

        half.device = step.device
        return half

    engine.make_train_step = make
    try:
        yield
    finally:
        engine.make_train_step = real


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}


def program(config: Dict, traffic: Dict, seed: int, device: torch.device, fault: str = "") -> Dict:
    """The program's check steps (with ``fault`` planted): its readings and
    its clips."""
    from benchmark.entries.train_epoch import Cell

    with FAULTS[fault]() if fault else contextlib.nullcontext():
        cell = Cell(config, traffic, seed, device)
        readings = cell.check_steps()
    clips = cell.clips
    cell.release()
    return {"readings": readings, "clips": clips}


def readings(config: Dict, traffic: Dict, seed: int, device: torch.device, what: str) -> Dict:
    """``what``'s readings against the f32 reference at ``seed``."""
    from benchmark import traffic as T
    from benchmark.entries.train_epoch import program_config

    if what == "control":
        _, cfg = program_config(config, traffic, T.sub_seeds(seed))
        clips = T.make_clips(config["train_clips"], cfg.model.max_frames, cfg.model.n_mels,
                             len(cfg.data.classes), traffic, T.sub_seeds(seed), device)
        got = ref_check.readings(config, traffic, clips, seed, device, mode="fp8")
    else:
        p = program(config, traffic, seed, device, "" if what == "program" else what)
        clips, got = p["clips"], p["readings"]
    ref = ref_check.readings(config, traffic, clips, seed, device)
    witness = ref_check.readings(config, traffic, clips, seed, device, mode="bf16")
    return ref_check.compare(got, ref, witness)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--what", nargs="+", default=["program", "control"],
                   choices=["program", "control", *FAULTS])
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("control.py reads the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    w = harness.load("workloads", a.workload)
    config, traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
    seen: Dict[str, Dict[str, list]] = {}
    for seed in a.seeds:
        for what in a.what:
            got = readings(config, traffic, seed, device, what)
            print(json.dumps({"seed": seed, "what": what, **got}), flush=True)
            for k, v in got.items():
                seen.setdefault(what, {}).setdefault(k, []).append(v["value"])
    print(json.dumps({what: {k: {"least": min(v), "largest": max(v)} for k, v in nums.items()}
                      for what, nums in seen.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
