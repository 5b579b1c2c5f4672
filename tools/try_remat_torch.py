#!/usr/bin/env python3
"""A/B activation checkpointing on the flagship train step of the PyTorch port.

The port's counterpart of ``tools/try_remat.py``, with its flags and
defaults (the flagship at ``--batch`` 64, bf16, ``--iters`` 20 steps a
variant).  It wraps the model's forward, inside the port's own
``make_train_step``, in four variants:

* ``baseline``: no checkpoint (autograd saves what the backward needs);
* ``nothing``: ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
  the whole forward runs again in the backward;
* ``dots``: selective checkpointing (``create_selective_checkpoint_contexts``)
  that saves the outputs of ``mm``, ``addmm``, ``bmm`` and ``convolution``
  and recomputes the rest;
* ``dropmask``: saves every output but the dropout keep masks (``rand`` and
  the ``lt`` that makes the mask), which the backward draws again.

The trap: the port's dropout draws from the step's explicit generator
(``ops/dropout.py``), and checkpoint's ``preserve_rng_state`` restores only
the default generators.  A naive recompute draws other masks, which gives
wrong gradients without an error, and advances the step's generator twice.
So every variant runs its forward, the first time and in the recompute, on a
generator of its own set to the step generator's state at the forward, and
hands the step generator the state the first run left: the masks are the
baseline's and the generator ends where the baseline leaves it.  Before any
timing the tool holds each variant's first step against ``baseline``'s in
f32 (the loss to 1e-5 of it, every gradient to 1e-3 of its leaf's largest
entry, the generator's state after the step exactly), then times each
variant's step, eagerly (a variant's own generator is nothing a CUDA graph
can hold, so the baseline runs so too): ms per step by CUDA events, device ms per step under the profiler,
the peak memory, with the card's name and power limit.

    python3 tools/try_remat_torch.py [--batch 64] [--iters 20]

Runs on ``cuda:0``; without a GPU it raises unless given ``--device cpu``
(host clock only: the tests' mode).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_step_torch import TrainSetup, step_config, train_setup  # noqa: E402
from sound_event_detection_transformer_tpu_torch.engine import make_train_step  # noqa: E402
from sound_event_detection_transformer_tpu_torch.models import resolve_device  # noqa: E402
from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    card_of,
    measure,
)

aten = torch.ops.aten
DOTS = (aten.mm, aten.addmm, aten.bmm, aten.convolution)
DROPOUT_MASK = (aten.rand, aten.lt)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of each leaf's largest gradient entry


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dropmask_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.PREFER_RECOMPUTE if op.overloadpacket in DROPOUT_MASK
            else CheckpointPolicy.MUST_SAVE)


POLICIES = {"nothing": None, "dots": _dots_policy, "dropmask": _dropmask_policy}
VARIANTS = ("baseline",) + tuple(POLICIES)


class Remat(torch.nn.Module):
    """``model`` with its forward under ``torch.utils.checkpoint`` and a
    selective ``policy`` (None: recompute everything).  With
    ``fix_generator`` the forward draws from its own generator set to the
    step generator's state at the forward, both times it runs, and the step
    generator then takes the state the first run left; without it, the
    recompute draws from the step generator as it stands (the naive form)."""

    def __init__(self, model: torch.nn.Module, policy=None, fix_generator: bool = True):
        super().__init__()
        self.model = model
        self.context_fn = (functools.partial(create_selective_checkpoint_contexts, policy)
                           if policy is not None else None)
        self.fix_generator = fix_generator

    def forward(self, feats, pad_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        kw = {"use_reentrant": False}
        if self.context_fn is not None:
            kw["context_fn"] = self.context_fn
        if not self.fix_generator or generator is None:
            return checkpoint(self.model, feats, pad_mask, deterministic=deterministic,
                              generator=generator, **kw)
        start, end = generator.get_state(), []

        def run(feats, pad_mask):
            own = torch.Generator(device=generator.device)
            own.set_state(start)
            out = self.model(feats, pad_mask, deterministic=deterministic, generator=own)
            end.append(own.get_state())
            return out

        out = checkpoint(run, feats, pad_mask, **kw)
        generator.set_state(end[0])
        return out


def variant_model(model: torch.nn.Module, variant: str, fix_generator: bool = True):
    """The module the variant's step runs."""
    return model if variant == "baseline" else Remat(model, POLICIES[variant], fix_generator)


class _GradCatcher:
    """An optimizer that keeps the gradients and updates nothing."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self) -> None:
        self.grads = {n: p.grad.detach().clone() for n, p in self.model.named_parameters()
                      if p.grad is not None}
        self.model.zero_grad(set_to_none=True)


def first_step(s: TrainSetup, variant: str, seed: int = 1, fix_generator: bool = True) -> dict:
    """One step of the variant through ``make_train_step``, from the setup's
    weights (left unchanged) and a generator seeded ``seed``: its loss, its
    gradients and the generator's state after it."""
    dev = s.step.device
    catcher = _GradCatcher(s.model)
    step = make_train_step(variant_model(s.model, variant, fix_generator), s.wd, s.cfg, catcher,
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = step(s.batch, gen)["loss"]
    return {"loss": float(loss), "grads": catcher.grads, "gen": gen.get_state()}


def compare(ref: dict, got: dict) -> dict:
    """How far a variant's first step lies from the baseline's: the loss
    relative to the baseline's, the worst gradient relative to its leaf's
    largest entry (and which leaf), and whether the generators agree."""
    worst, leaf = 0.0, None
    for n, g in ref["grads"].items():
        scale = float(g.abs().max()) or 1.0
        err = float((got["grads"][n] - g).abs().max()) / scale
        if err > worst:
            worst, leaf = err, n
    return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), "grad": worst,
            "leaf": leaf, "same_generator": torch.equal(got["gen"], ref["gen"]),
            "same_leaves": got["grads"].keys() == ref["grads"].keys()}


def check_variants(s: TrainSetup) -> dict:
    """Each variant's first step against the baseline's; raises on a miss."""
    ref = first_step(s, "baseline")
    out = {}
    for v in VARIANTS[1:]:
        out[v] = d = compare(ref, first_step(s, v))
        if not (d["loss"] <= LOSS_RTOL and d["grad"] <= GRAD_TOL and d["same_generator"]
                and d["same_leaves"]):
            raise AssertionError(f"variant {v} does not reproduce the baseline's step: {d}")
    return out


class EagerOptimizer:
    """An optimizer behind a duck type, so that ``make_train_step`` runs its
    step eagerly (``engine.graphs_engage``).  Every variant's step runs so:
    a ``Remat`` forward draws from a generator of its own, which no CUDA
    graph can hold, and the baseline is timed as the variants are."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def step(self) -> None:
        self.optimizer.step()


def time_variants(s: TrainSetup, iters: int) -> dict:
    """{variant: (Reading of an eager step, peak memory in bytes or None)}."""
    dev = s.step.device
    out = {}
    for v in VARIANTS:
        step = make_train_step(variant_model(s.model, v), s.wd, s.cfg,
                               EagerOptimizer(s.optimizer), device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        r = measure(lambda: step(s.batch, s.gen), iters, dev)
        out[v] = (r, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", default=64, type=int)
    ap.add_argument("--iters", default=20, type=int)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--tiny", action="store_true", help="64 frames")
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda:0")
    card = card_of(dev)
    cfg = step_config(args.batch, args.compute_dtype, args.tiny)
    f32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    checked = check_variants(train_setup(f32, dev))
    for v, d in checked.items():
        print(f"{v:10s}: first f32 step as baseline's: loss {d['loss']:.3g} of it, gradients "
              f"{d['grad']:.3g} of their leaf's largest ({d['leaf']}), generator "
              f"{'the same' if d['same_generator'] else 'NOT the same'}")
    timed = time_variants(train_setup(cfg, dev), args.iters)
    for v, (r, peak) in timed.items():
        dev_text = ("device not measured" if r.device_ms is None
                    else f"device {r.device_ms:7.2f} ms")
        mem = "" if peak is None else f", peak memory {peak / 2**30:.2f} GiB"
        print(f"{v:10s}: {r.ms:7.2f} ms/step ({args.batch / r.ms * 1e3:7.0f} clips/s), "
              f"{dev_text}{mem} ({card})")
    return {"checked": checked, "timed": timed}


if __name__ == "__main__":
    main()
