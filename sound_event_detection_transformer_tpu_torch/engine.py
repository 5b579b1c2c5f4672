"""Evaluation step of the port.

Counterpart of the JAX package's ``engine.make_eval_step``: the deterministic
forward, the set criterion (one joint Hungarian solve of the final and aux
decoder layers, kernel K1 or K2 on the GPU) and the fusion post-processing, with
the same result dict.  The training steps land in later slices.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from .config import SEDTConfig
from .models import postprocess, resolve_device, set_criterion
from .models.criterion import DenseTargets


class Batch(NamedTuple):
    feats: torch.Tensor  # [B, T, F, 1]
    pad_mask: torch.Tensor  # [B, T] bool, True = padded
    targets: DenseTargets
    strong: torch.Tensor  # [B] bool
    weak: torch.Tensor  # [B] bool
    indexes: Optional[torch.Tensor] = None  # [B] dataset row ids (eval)


def make_eval_step(
    model: torch.nn.Module,
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    fusion_strategy: Sequence[int],
    device: Optional[torch.device | str] = None,
) -> Callable[[Batch, torch.Tensor], Dict]:
    """Returns ``step(batch, valid)``.

    ``valid`` ([B] bool) marks real rows; padded tail rows are excluded from
    the loss masks.  The result holds ``losses`` (the criterion's dict),
    ``at`` (with ``dec_at``) and ``pp_{m}`` (a :class:`PostProcessResult`)
    for each fusion strategy ``m``.  The model's parameters live on
    ``device``; the batch is moved there.  ``weight_dict`` is not read:
    the step returns the raw losses, as the JAX package's does, and the
    caller weights them.
    """
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device != dev:
        raise ValueError(f"model is on {param.device}, eval step on {dev}")
    fusion_strategy = tuple(fusion_strategy)

    @torch.inference_mode()
    def step(batch: Batch, valid: torch.Tensor) -> Dict:
        to = lambda t: t.to(dev, non_blocking=True)
        targets = DenseTargets(*(to(t) for t in batch.targets))
        out = model(to(batch.feats), to(batch.pad_mask))
        losses, _ = set_criterion(
            out, targets, to(batch.strong) & to(valid), None, cfg.model, cfg.loss
        )
        res = {"losses": losses}
        audio_tags = None
        if "at" in out:
            audio_tags = (out["at"] > 0.5).float()
            res["at"] = out["at"]
        for at_m in fusion_strategy:
            res[f"pp_{at_m}"] = postprocess(
                out, targets.orig_size, audio_tags=audio_tags, at_m=at_m
            )
        return res

    return step
