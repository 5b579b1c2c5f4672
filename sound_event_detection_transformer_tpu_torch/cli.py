"""Console entry point of the port's supervised trainer.

Counterpart of the JAX package's ``cli.main_sedt``: the repo-root script
``train_sedt_torch.py`` and the installed ``sedt-train-torch`` command both
land here, so the flag defaulting lives in one place.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .train_lib import TrainResult, get_parser, run_supervised


def sedt_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The trainer's arguments: ``--eval`` runs the final test only (it sets
    ``epochs`` to 0 and needs ``--info``), and ``--info`` defaults to a name
    built from the configuration."""
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.eval:
        args.epochs = 0
        if not args.info:
            parser.error("give the model information (--info) to be evaluated")
    if args.info is None:
        args.info = (
            f"{args.dataname}_atloss_{args.weak_loss_coef}"
            f"_atploss_{args.weak_loss_p_coef}_enc_{args.enc_layers}"
            f"_pooling_{args.pooling}_{args.fusion_strategy}"
        )
        if args.pretrain:
            args.info += "_" + args.pretrain
    return args


def main_sedt(argv: Optional[Sequence[str]] = None,
              device: Optional[torch.device | str] = None) -> TrainResult:
    """Supervised training and evaluation on the GPU (``device`` for tests)."""
    return run_supervised(sedt_args(argv), device=device)
