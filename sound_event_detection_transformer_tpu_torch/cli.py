"""Console entry points of the port's trainers.

Counterpart of the JAX package's ``cli.main_sedt``, ``cli.main_spsedt``,
``cli.main_semi`` and ``cli.main_at``: the repo-root scripts
``train_sedt_torch.py``, ``train_spsedt_torch.py``, ``train_ss_sedt_torch.py``
and ``train_at_torch.py`` and the installed ``sedt-train-torch``,
``sedt-pretrain-torch``, ``sedt-semi-torch`` and ``sedt-audio-tag-torch``
commands land here, so the flag defaulting lives in one place.  Under
``torchrun --nproc_per_node N`` (``WORLD_SIZE`` > 1) each entry point joins
the process group first (``parallel.distribute.init_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo when ``device`` is the CPU).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .parallel.distribute import init_distributed
from .parallel.optim import AST_LR

from .train_lib import (
    AudioTagResult,
    PretrainResult,
    TrainResult,
    get_parser,
    run_audio_tag,
    run_semi,
    run_spsedt,
    run_supervised,
)


def join_group(device: Optional[torch.device | str] = None) -> None:
    """Join torchrun's process group when ``WORLD_SIZE`` > 1 (a group that
    exists is kept)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(device=device)


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
    args = sedt_args(argv)
    join_group(device)
    return run_supervised(args, device=device)


def spsedt_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The SP-SEDT pretrainer's arguments: the trainer's flags and
    ``--extra_data``; DCASE or ``--synthetic_smoke`` only, and ``--info``
    defaults to ``pretrain_enc_<n>`` with ``_feature_recon`` and
    ``_fixed_patch_size`` as those flags are set."""
    parser = get_parser()
    parser.add_argument("--extra_data", action="store_true", default=False,
                        help="also pretrain on DCASE 2018 task 5 (dcase2018_task5.tsv)")
    args = parser.parse_args(argv)
    if args.dataname != "dcase" and not args.synthetic_smoke:
        parser.error("SP-SEDT pretrains on the dcase dataset (or --synthetic_smoke) only")
    if args.info is None:
        args.info = f"pretrain_enc_{args.enc_layers}"
        if args.feature_recon:
            args.info += "_feature_recon"
        if args.fixed_patch_size:
            args.info += "_fixed_patch_size"
    return args


def main_spsedt(argv: Optional[Sequence[str]] = None,
                device: Optional[torch.device | str] = None) -> PretrainResult:
    """SP-SEDT self-supervised pretraining on the GPU (``device`` for tests)."""
    args = spsedt_args(argv)
    join_group(device)
    return run_spsedt(args, device=device)


def semi_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The semi trainer's arguments: the trainer's flags and ``--ema_m``
    (the teacher's EMA decay, set as ``ema_decay``), ``--semi_batch_size``
    and ``--teacher_eval`` (on unless given: validate the teacher, not the
    student); DCASE or ``--synthetic_smoke`` only; ``--eval`` runs the final
    test only (``epochs`` 0, needs ``--info``); ``--info`` defaults to
    ``semi_supervised_`` and a name built from the configuration."""
    parser = get_parser()
    parser.add_argument("--ema_m", type=float, default=0.9996,
                        help="EMA decay of the teacher")
    parser.add_argument("--semi_batch_size", default=64, type=int)
    parser.add_argument("--teacher_eval", action="store_false", default=True,
                        help="validate the student instead of the EMA teacher")
    args = parser.parse_args(argv)
    args.ema_decay = args.ema_m
    if args.dataname != "dcase" and not args.synthetic_smoke:
        parser.error("the semi trainer runs on the dcase dataset (or --synthetic_smoke) only")
    if args.eval:
        args.epochs = 0
        if not args.info:
            parser.error("give the model information (--info) to be evaluated")
    if args.info is None:
        args.info = (
            f"semi_supervised_{args.dataname}_atloss_{args.weak_loss_coef}"
            f"_atploss_{args.weak_loss_p_coef}_enc_{args.enc_layers}"
            f"_pooling_{args.pooling}_{args.fusion_strategy}"
        )
    return args


def main_semi(argv: Optional[Sequence[str]] = None,
              device: Optional[torch.device | str] = None) -> TrainResult:
    """Semi-supervised mean-teacher training on the GPU (``device`` for tests)."""
    args = semi_args(argv)
    join_group(device)
    return run_semi(args, device=device)


def at_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The audio-tag trainer's arguments: the trainer's flags and
    ``--nepochs`` (sets ``epochs`` when given) and ``--fix_backbone``
    (parsed, without effect, as in the JAX package); ``--pooling`` defaults
    to ``avg`` and ``--info`` to ``at_<pooling>_<dataname>``.  The port's
    own: ``--at_model`` (``resnet``, the JAX package's model, or ``ast``,
    ``train_lib.audio_tag_ast``); ``--lr`` defaults to AST's recipe's 1e-5
    with ``ast``."""
    parser = get_parser()
    parser.add_argument("--nepochs", type=int, default=None, help="alias of --epochs")
    parser.add_argument("--fix_backbone", action="store_true", default=False,
                        help="accepted for the reference's command lines; no effect (the JAX "
                             "package's trainer ignores it too): every parameter trains")
    parser.add_argument("--at_model", default="resnet", choices=("resnet", "ast"),
                        help="the tagger: the ResNet backbone with a pooled MLP head, or AST")
    lr_default = parser.get_default("lr")
    parser.set_defaults(lr=None)
    args = parser.parse_args(argv)
    if args.lr is None:
        args.lr = AST_LR if args.at_model == "ast" else lr_default
    if args.nepochs is not None:
        args.epochs = args.nepochs
    if args.pooling is None:
        args.pooling = "avg"
    if args.info is None:
        args.info = f"at_{args.pooling}_{args.dataname}"
    return args


def main_at(argv: Optional[Sequence[str]] = None,
            device: Optional[torch.device | str] = None) -> AudioTagResult:
    """Audio-tag backbone training on the GPU (``device`` for tests)."""
    args = at_args(argv)
    join_group(device)
    return run_audio_tag(args, device=device)
