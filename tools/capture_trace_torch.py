#!/usr/bin/env python3
"""Capture a ``torch.profiler`` trace of a train step on the PyTorch port.

The port's counterpart of ``tools/capture_trace.py``, with its flags and
geometries: by default the flagship train step (``profile_step_torch``'s, at
batch 64); ``--semi`` the mean-teacher step at ``profile_semi_torch``'s
DCASE geometry (6+6 layers, 20 queries, ``dec_at``, batch 64); ``--spsedt``
the SP-SEDT pretraining step at ``profile_spsedt_torch``'s (6+6 layers, 20
queries from 10 patches, feature reconstruction, batch 200).  After three
warm-up steps it traces ``--iters`` steps, each in an ``annotate("step i")``
range, into ``--out`` (``utils.profiler.trace``: a Chrome trace
``*.pt.trace.json``), then prints where the trace went.  Read it with
``tools/trace_report_torch.py``:

    python3 tools/capture_trace_torch.py [--out build/torch_trace] [--iters 5] [--semi | --spsedt]
    python3 tools/trace_report_torch.py build/torch_trace

``--host_patches`` raises: the port always crops SP-SEDT's patches on the
device.  Runs on ``cuda:0``; without a GPU it raises unless given
``--device cpu`` (a trace of the host only: the tests' mode).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_semi_torch import semi_config, semi_setup  # noqa: E402
from profile_spsedt_torch import spsedt_config, spsedt_setup  # noqa: E402
from profile_step_torch import step_config, train_setup  # noqa: E402
from sound_event_detection_transformer_tpu_torch.models import resolve_device  # noqa: E402
from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    annotate,
    find_trace,
    trace,
)

WARMUP = 3


def capture(run, out: str, iters: int, warmup: int = WARMUP) -> str:
    """``warmup`` calls of ``run``, then ``iters`` traced ones, each in an
    ``annotate("step i")`` range; returns the trace's path."""
    for _ in range(warmup):
        run()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with trace(out):
        for i in range(iters):
            with annotate(f"step {i}"):
                run()
        sync()
    return find_trace(out)


def setup_for(mode: str, device: torch.device, batch=None, compute_dtype=None):
    """The step a mode traces (``"flagship"``, ``"semi"`` or ``"spsedt"``),
    at the JAX tool's geometry, with ``batch`` and ``compute_dtype``
    overriding it."""
    if mode == "spsedt":
        cfg = spsedt_config(batch or 200)
    elif mode == "semi":
        cfg = semi_config(batch or 64)
    else:
        cfg = step_config(batch or 64, compute_dtype="bfloat16")
    if compute_dtype:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype))
    make = {"spsedt": spsedt_setup, "semi": semi_setup}.get(mode, train_setup)
    return make(cfg, device)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/torch_trace")
    ap.add_argument("--iters", default=5, type=int)
    ap.add_argument("--batch", default=None, type=int,
                    help="batch size (default: 64 flagship and semi, 200 spsedt)")
    ap.add_argument("--compute_dtype", default=None, help="override the model's compute dtype")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--semi", action="store_true", help="trace the mean-teacher semi step")
    mode.add_argument("--spsedt", action="store_true",
                      help="trace the SP-SEDT pretraining step (batch 200, 10 patches)")
    ap.add_argument("--host_patches", action="store_true",
                    help="refused: the port crops the patches on the device")
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    if args.host_patches:
        raise ValueError("--host_patches: the port always crops SP-SEDT's patches on the "
                         "device (ops/patches.extract_patches_device); there is no host crop")
    dev = resolve_device(args.device or "cuda:0")
    name = "spsedt" if args.spsedt else "semi" if args.semi else "flagship"
    s = setup_for(name, dev, args.batch, args.compute_dtype)
    path = capture(s.run, args.out, args.iters)
    print(f"trace written to {path} (dtype={s.cfg.model.compute_dtype}, {args.iters} steps, "
          f"{name} batch={s.cfg.data.batch_size}"
          + (f" patches={s.cfg.model.num_patches} device crops" if args.spsedt else "") + ")")
    return path


if __name__ == "__main__":
    main()
