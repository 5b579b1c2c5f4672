#!/usr/bin/env python3
"""Component timing of the flagship train step on the PyTorch port.

The port's counterpart of ``tools/profile_step.py``, with its flags and
defaults: the URBAN-SED recipe (``bench_torch.flagship_config``: ResNet-50
DC5, 3+3 layers, d 256, ``dec_at``, 500 x 64 clips) at ``--batch`` clips,
f32 compute unless ``--compute_dtype bfloat16``, on ``bench_torch``'s
synthetic batch, through the port's ``make_train_step``.  Rows, as the JAX
tool's: ``train_step``, ``forward_eval`` (the deterministic forward),
``forward_plus_criterion``, ``matcher_batch`` (kernel K1,
``ops/hungarian.lsap_lane``, on the step's own cost [3 * B, 10, 20]),
``forward_backward`` (deterministic, no update), ``optimizer_update`` (clip
and AdamW), ``backbone``, ``criterion_only`` and the difference
``backward_plus_update`` (``train_step`` less ``forward_plus_criterion``).
The JAX tool subtracts ``forward_eval`` from ``forward_plus_criterion`` for
``criterion_only``; here that would be the difference of two host-bound
readings, which came out negative on the card, so the criterion is timed
on its own on one forward's outputs.  On the card ``train_step`` times the
step as the trainer runs it, from its second call a replayed CUDA graph
(``engine.StepGraphs``); the other rows call the model, ``make_loss_fn``,
the criterion and the optimizer themselves.

Every row has two readings: ms per call by CUDA events around back-to-back
calls (``utils.profiler.cuda_ms``), which is the host's issue time whenever
the path is host-bound, and device ms per call under the profiler
(``busy_ms``; ``matcher_batch``: a replayed CUDA graph, ``device_ms``).  The
card's name and power limit stand beside every time.

    python3 tools/profile_step_torch.py [--compute_dtype bfloat16] [--batch 64] [--iters 20]

Runs on ``cuda:0``; without a GPU it raises unless given ``--device cpu``
(host clock only, no device time: the tests' mode).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import flagship_config, synthetic_batch  # noqa: E402
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig  # noqa: E402
from sound_event_detection_transformer_tpu_torch.engine import (  # noqa: E402
    Batch,
    init_train_state,
    make_loss_fn,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import (  # noqa: E402
    build_model,
    resolve_device,
    set_criterion,
    total_loss,
)
from sound_event_detection_transformer_tpu_torch.ops import hungarian, matcher  # noqa: E402
from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    Reading,
    card_of,
    measure,
)

ROWS = ("train_step", "forward_eval", "forward_plus_criterion", "matcher_batch",
        "forward_backward", "optimizer_update", "backbone", "criterion_only",
        "backward_plus_update")
# rows that solve the matching once a call: K1 launches once per call on the card
K1_ROWS = ("train_step", "forward_plus_criterion", "matcher_batch", "forward_backward",
           "criterion_only")


class TrainSetup(NamedTuple):
    """A train step ready to run: ``run()`` takes one step on ``batch``."""

    model: torch.nn.Module
    wd: Dict[str, float]
    cfg: SEDTConfig
    optimizer: object
    batch: Batch
    gen: torch.Generator
    step: object

    def run(self) -> Dict[str, torch.Tensor]:
        return self.step(self.batch, self.gen)


def with_lsap_costs(call) -> tuple:
    """``call()``, with the cost of every ``lsap`` call it makes kept:
    (what ``call`` returns, [costs])."""
    seen = []
    matcher.lsap = lambda cost: (seen.append(cost.clone()), hungarian.lsap(cost))[1]
    try:
        out = call()
    finally:
        matcher.lsap = hungarian.lsap
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, seen


def step_config(batch: int = 64, compute_dtype: str = "float32", tiny: bool = False,
                dropout: Optional[float] = None) -> SEDTConfig:
    """The JAX tool's configuration: the flagship at ``batch``, 64 frames
    with ``tiny``, the model's dropout overridden by ``dropout``."""
    cfg = flagship_config(batch)
    kw = {"compute_dtype": compute_dtype}
    if tiny:
        kw["max_frames"] = 64
    if dropout is not None:
        kw["dropout"] = dropout
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def train_setup(cfg: SEDTConfig, device: torch.device, batch: Optional[Batch] = None,
                augment_on: bool = True, steps_per_epoch: int = 100) -> TrainSetup:
    """``bench_torch``'s step: weights from seed 0, the step's generator from
    seed 1, the batch (``synthetic_batch`` unless given) on ``device``."""
    model, wd = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg, steps_per_epoch)
    step = make_train_step(model, wd, cfg, state.optimizer, augment_on=augment_on,
                           device=device)
    if batch is None:
        batch = synthetic_batch(cfg, cfg.data.batch_size, device)
    gen = torch.Generator(device=device).manual_seed(1)
    return TrainSetup(model, wd, cfg, state.optimizer, batch, gen, step)


def compute_autocast(cfg: SEDTConfig, device: torch.device):
    """The model's autocast context for its compute dtype."""
    if cfg.model.compute_dtype == "float32":
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=getattr(torch, cfg.model.compute_dtype))


def step_rows(s: TrainSetup, iters: int, step_only: bool = False) -> Dict[str, Reading]:
    """Every row of the JAX tool (see the module docstring).  Besides the
    rows' calls, one more training forward and criterion runs
    (``make_loss_fn``), whose cost ``matcher_batch`` solves."""
    dev = s.step.device
    rows = {"train_step": measure(s.run, iters, dev)}
    if step_only:
        return rows
    model, b, cfg = s.model, s.batch, s.cfg

    def forward_loss():
        out = model(b.feats, b.pad_mask)
        losses, _ = set_criterion(out, b.targets, b.strong, b.weak, cfg.model, cfg.loss)
        return total_loss(losses, s.wd)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        forward_loss().backward()

    with torch.no_grad():
        rows["forward_eval"] = measure(lambda: model(b.feats, b.pad_mask), iters, dev)
        rows["forward_plus_criterion"] = measure(forward_loss, iters, dev)
        out = model(b.feats, b.pad_mask)
        rows["criterion_only"] = measure(lambda: total_loss(set_criterion(
            out, b.targets, b.strong, b.weak, cfg.model, cfg.loss)[0], s.wd), iters, dev)
    loss_fn = make_loss_fn(model, s.wd, cfg)
    with torch.no_grad():  # the step's training forward: a replayed step runs no Python
        _, (cost,) = with_lsap_costs(lambda: loss_fn(b.feats, b.pad_mask, b.targets, b.strong,
                                                      b.weak, s.gen))
    rows["matcher_batch"] = measure(lambda: hungarian.lsap_lane(cost), iters, dev, graph=True)
    rows["forward_backward"] = measure(forward_backward, iters, dev)
    rows["optimizer_update"] = measure(s.optimizer.step, iters, dev)
    with torch.no_grad(), compute_autocast(cfg, dev):
        rows["backbone"] = measure(lambda: model.backbone(b.feats), iters, dev)
    diff = lambda a, c: Reading(rows[a].ms - rows[c].ms,
                                None if rows[a].device_ms is None
                                else rows[a].device_ms - rows[c].device_ms, 0)
    rows["backward_plus_update"] = diff("train_step", "forward_plus_criterion")
    return {k: rows[k] for k in ROWS}


def format_row(name: str, r: Reading, batch: int, card: str) -> str:
    dev = ("device not measured" if r.device_ms is None
           else f"device {r.device_ms:9.4f} ms ({batch / r.device_ms * 1e3:8.0f} clips/s)")
    return (f"  {name:26s} {r.ms:9.4f} ms  ({batch / r.ms * 1e3:8.0f} clips/s)  {dev}  "
            f"({card})")


def main(argv=None) -> Dict[str, Reading]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", default=64, type=int)
    ap.add_argument("--iters", default=20, type=int)
    ap.add_argument("--tiny", action="store_true",
                    help="64 frames (a sanity check of the harness)")
    ap.add_argument("--dropout", default=None, type=float,
                    help="override the model's dropout (e.g. 0 to cost the masks)")
    ap.add_argument("--step_only", action="store_true", help="only time the full train step")
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda:0")
    card = card_of(dev)
    cfg = step_config(args.batch, args.compute_dtype, args.tiny, args.dropout)
    rows = step_rows(train_setup(cfg, dev), args.iters, args.step_only)
    print(f"batch={args.batch} dtype={args.compute_dtype} dropout={cfg.model.dropout} "
          f"iters={args.iters} ({card})")
    for name, r in rows.items():
        print(format_row(name, r, args.batch, card))
    return rows


if __name__ == "__main__":
    main()
