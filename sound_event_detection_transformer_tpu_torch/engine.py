"""Training and evaluation steps of the port.

Counterpart of the JAX package's ``engine.py``:

* ``make_train_step``: the supervised step (optional frontend on waveforms,
  augmentation, the forward with dropout, the set criterion with its
  Hungarian matching on kernel K1 or K2, backward, clip, two-group AdamW),
  and with a ``self_sup`` config the SP-SEDT step (the patch crops gathered
  on the device from the target boxes, the patch-query forward, the
  criterion with the feature-reconstruction loss);
* ``make_eval_step``: the deterministic forward, the set criterion (one joint
  Hungarian solve of the final and aux decoder layers) and the fusion
  post-processing, with the same result dict.

The JAX package's frozen-leaf mask (``_frozen_param_mask`` /
``_swap_in_frozen``) becomes ``requires_grad=False`` on the frozen
parameters, which :func:`.parallel.optim.make_optimizer` sets and keeps out
of the optimizer.  The semi-supervised step lands in a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .config import SEDTConfig
from .models import postprocess, resolve_device, set_criterion, total_loss
from .models.criterion import DenseTargets
from .ops import augment
from .ops.patches import extract_patches_device
from .parallel.optim import SEDTOptimizer, make_optimizer


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
    """Returns ``step(batch, valid)``, with the device it runs on as
    ``step.device``.

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

    step.device = dev
    return step


class TrainState(NamedTuple):
    """The model (parameters and FrozenBN buffers) and its optimizer, which
    counts the steps (``micro_steps``) and the updates (``updates``)."""

    model: torch.nn.Module
    optimizer: SEDTOptimizer


def init_train_state(model: torch.nn.Module, cfg: SEDTConfig, steps_per_epoch: int,
                     schedule: str = "step", fixed_lr: Optional[float] = None) -> TrainState:
    """Freeze the frozen parameters and build the optimizer over the rest."""
    return TrainState(model, make_optimizer(model, cfg.train, steps_per_epoch, schedule,
                                            fixed_lr))


def _apply_augment(cfg: SEDTConfig, feats: torch.Tensor, targets: DenseTargets,
                   strong: torch.Tensor, weak: torch.Tensor,
                   generator: Optional[torch.Generator]):
    """The augmentations ``cfg.augment`` turns on, in the JAX package's order."""
    a = cfg.augment
    if a.mix_up_ratio > 0:
        feats, targets, strong, weak = augment.mixup(
            feats, targets, strong, weak, generator, mix_up_ratio=a.mix_up_ratio,
            alpha=1.0, max_events=cfg.model.max_events)
    if a.time_mask:
        feats = augment.time_mask(feats, generator)
    if a.freq_mask:
        feats = augment.freq_mask(feats, generator)
    if a.freq_shift:
        feats = augment.freq_shift(feats, generator)
    return feats, targets, strong, weak


def make_loss_fn(model: torch.nn.Module, weight_dict: Dict[str, float], cfg: SEDTConfig,
                 fine_tune: bool = False, normalize: bool = False, fl: bool = False):
    """``loss_fn(feats, pad_mask, targets, strong, weak, generator,
    patches=None)`` -> (weighted loss, the criterion's losses): the training
    forward (dropout on; the masks, SP-SEDT's query shuffle and keep mask,
    and the relaxed matching's draws from ``generator``) and the set
    criterion, differentiable with respect to the model's parameters.
    ``patches`` ([B, P, ph, pw, 1]) goes to an :class:`~.models.SPSEDT`."""

    def loss_fn(feats, pad_mask, targets, strong, weak, generator, patches=None):
        if patches is not None:
            out = model(feats, pad_mask, patches, deterministic=False, generator=generator)
        else:
            out = model(feats, pad_mask, deterministic=False, generator=generator)
        losses, _ = set_criterion(out, targets, strong, weak, cfg.model, cfg.loss,
                                  fine_tune=fine_tune, normalize=normalize, fl=fl,
                                  generator=generator)
        return total_loss(losses, weight_dict), losses

    return loss_fn


def make_train_step(
    model: torch.nn.Module,
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    optimizer: SEDTOptimizer,
    fine_tune: bool = False,
    normalize: bool = False,
    fl: bool = False,
    augment_on: bool = True,
    frontend_fn: Optional[Callable] = None,
    device: Optional[torch.device | str] = None,
) -> Callable[[Batch, Optional[torch.Generator]], Dict[str, torch.Tensor]]:
    """The supervised step: ``step(batch, generator) -> metrics``, with the
    device it runs on as ``step.device``.

    The batch is moved to ``device`` (the GPU when None).  With
    ``frontend_fn`` (see :func:`.ops.frontend.make_frontend_fn`),
    ``batch.feats`` carries raw waveforms [B, num_samples] and the step
    featurises them first, with an all-False pad mask.  ``generator`` (on
    ``device``) draws the augmentations, the dropout masks and the relaxed
    matching, in that order (SP-SEDT: the query shuffle and keep mask before
    the dropout masks).  With a ``self_sup`` config the step crops the
    patches on the device from the first ``num_patches`` target boxes of the (augmented) features.  The
    metrics are ``{"loss", **losses}`` as tensors on the device; the step
    makes no host sync.
    """
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device != dev:
        raise ValueError(f"model is on {param.device}, train step on {dev}")
    loss_fn = make_loss_fn(model, weight_dict, cfg, fine_tune, normalize, fl)

    def step(batch: Batch, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        to = lambda t: t.to(dev, non_blocking=True)
        feats, pad_mask = to(batch.feats), to(batch.pad_mask)
        targets = DenseTargets(*(to(t) for t in batch.targets))
        strong, weak = to(batch.strong), to(batch.weak)
        with torch.enable_grad():
            if frontend_fn is not None:
                with torch.no_grad():
                    feats = frontend_fn(feats)
                pad_mask = torch.zeros(feats.shape[:2], dtype=torch.bool, device=dev)
            if augment_on:
                feats, targets, strong, weak = _apply_augment(cfg, feats, targets, strong,
                                                              weak, generator)
            patches = None
            if cfg.model.self_sup:
                patches = extract_patches_device(feats,
                                                 targets.boxes[:, :cfg.model.num_patches])
            loss, losses = loss_fn(feats, pad_mask, targets, strong, weak, generator, patches)
            loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}

    step.device = dev
    return step
