"""Model zoo of the port: SEDT, SP-SEDT, their criterion and post-processing, and the
audio-tag models (the ResNet tagger and AST)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import SEDTConfig
from .ast import AST, AUDIOSET, ASTConfig
from .criterion import DenseTargets, build_weight_dict, empty_targets, set_criterion, total_loss
from .postprocess import PostProcessResult, postprocess
from .resnet import AudioTagBackbone, ResNetBackbone, num_backbone_channels
from .sedt import MLP, SEDT, SPSEDT
from .transformer import Transformer, block_diagonal_bias

__all__ = [
    "SEDT",
    "SPSEDT",
    "MLP",
    "ResNetBackbone",
    "AudioTagBackbone",
    "AST",
    "ASTConfig",
    "AUDIOSET",
    "Transformer",
    "DenseTargets",
    "empty_targets",
    "set_criterion",
    "total_loss",
    "build_weight_dict",
    "postprocess",
    "PostProcessResult",
    "build_model",
    "resolve_device",
    "num_backbone_channels",
    "block_diagonal_bias",
]


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device; a bare ``"cuda"`` also means the current one.
    Without a GPU the caller must ask for the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to run on the CPU"
        )
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def build_model(cfg: SEDTConfig, device: Optional[torch.device | str] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[SEDT, Dict[str, float]]:
    """(SEDT module in eval mode on ``device``, loss-weight dict).

    A ``self_sup`` config gives :class:`SPSEDT` with one class and no
    audio-tag query, as in the JAX package.  Parameters are f32 and drawn on
    the CPU (from ``generator`` when given, so a seed fixes them), then moved
    to ``device``.
    """
    dev = resolve_device(device)
    mcfg = cfg.model
    if mcfg.self_sup:
        mcfg = dataclasses.replace(mcfg, num_classes=1, dec_at=False)
    with torch.random.fork_rng(devices=[]):
        if generator is not None:
            torch.random.default_generator.set_state(generator.get_state())
        model = SPSEDT(mcfg) if mcfg.self_sup else SEDT(mcfg)
    return model.to(dev).eval(), build_weight_dict(mcfg, cfg.loss)
