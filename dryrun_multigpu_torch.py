"""Multi-process dryrun of the PyTorch port's training steps.

The counterpart of the JAX package's multichip dryrun: five legs (the
supervised step, the mean-teacher step, the sharded feature bank's gather
fed to the step, the SP-SEDT step and the audio-tag step) run at the tiny
test config on N processes of one ``torch.distributed`` group laid out as
(data x model), each against the same leg at world 1 on the same global
batch: the first step's gradients leaf by leaf, the loss to 1e-5 relative,
the updated parameters to 1e-3 of the lr on the entries that the gradients
pin, the replicated parameters equal bit for bit on every rank and each
cut one equal across its data ranks, the bank's rows equal to the
dataset's (``parallel/dryrun.py``).  The layout follows the JAX dryrun's
rule: two model ranks (the attention heads and FFN hidden units split over
them) when the world is even and at least 4, else every rank on the data
axis; ``--n_model`` overrides it.

    python3 dryrun_multigpu_torch.py                       # world 2 = 2 x 1 on cuda:0 (gloo)
    python3 dryrun_multigpu_torch.py --world 4             # world 4 = 2 x 2 on cuda:0 (gloo)
    python3 dryrun_multigpu_torch.py --world 4 --device cuda  # a card per rank (NCCL)
    python3 dryrun_multigpu_torch.py --device cpu          # world 2 on the CPU (gloo)

``--device cuda`` gives rank r ``cuda:r`` and defaults to NCCL; every rank
on one device (``cuda:<i>`` or ``cpu``) defaults to gloo, since NCCL refuses
two ranks on one card.  Without a CUDA device only ``--device cpu`` runs.
Prints one JSON line per leg and ``{"ok": ...}`` last, each with the layout
``[n_data, n_model]``; exits 1 when a leg misses.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from sound_event_detection_transformer_tpu_torch.config import MeshConfig
from sound_event_detection_transformer_tpu_torch.parallel.distribute import layout_shape
from sound_event_detection_transformer_tpu_torch.parallel.dryrun import (
    default_mesh,
    run_dryrun,
    tiny_inputs,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda:0", help="cuda:<i> (every rank), cuda (rank r on "
                   "cuda:r) or cpu")
    p.add_argument("--backend", choices=("gloo", "nccl"),
                   help="default: nccl for --device cuda, else gloo")
    p.add_argument("--n_model", type=int, help="model ranks (default: 2 for an even world "
                   ">= 4, else 1)")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--workdir", default="build/dryrun_multigpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    args.backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    mesh = default_mesh(args.world) if args.n_model is None else MeshConfig(n_model=args.n_model)
    n_data, n_model = layout_shape(mesh, args.world)
    torch.manual_seed(0)
    inputs = tiny_inputs(args.device, batch=4 * n_data, steps=args.steps)
    report = run_dryrun(inputs, args.world, args.workdir, device=args.device,
                        backend=args.backend, mesh=mesh)
    for name, r in report.items():
        print(json.dumps({"leg": name, **r}, default=float))
    ok = all(r["ok"] for r in report.values())
    print(json.dumps({"ok": ok, "world": args.world, "layout": [n_data, n_model],
                      "backend": args.backend, "device": args.device}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
