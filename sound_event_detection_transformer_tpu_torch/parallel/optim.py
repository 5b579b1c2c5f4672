"""Optimizer assembly: AdamW in two groups, freeze policy, LR schedules, EMA;
the audio-tag trainer's clipped Adam.

Counterpart of the JAX package's ``parallel/optim.py``:

* the freeze policy: of the backbone only ``conv0`` and ``layer2``-``layer4``
  train; the stem ``conv1`` and ``layer1`` are frozen.  Frozen parameters get
  ``requires_grad=False`` and stay out of the optimizer, so they add nothing
  to the clip's global norm and get no weight-gradient convolution (the
  backward still runs through them for the input gradient that ``conv0``
  needs).  FrozenBN statistics are buffers and never reach the optimizer;
* clip by global norm, optax's rule: scale by max / norm when norm >= max
  (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead);
* AdamW with two groups, ``main`` at ``lr`` and ``backbone`` at
  ``lr_backbone``, decaying every parameter of both on every update, as
  optax's ``add_decayed_weights`` does (so a parameter with no gradient gets a
  zero one, which ``torch.optim.AdamW`` would otherwise skip);
* StepLR or cosine schedules counted in optimizer updates, not micro-steps;
* averaging gradient accumulation (optax ``MultiSteps``): the update comes on
  every k-th step, from the mean of the k gradients;
* the mean-teacher EMA;
* the audio-tag trainer's ``optax.chain(clip_by_global_norm, adam(staircase
  exponential decay))`` (:func:`make_audio_tag_optimizer`): the same
  optimizer over every parameter, no freeze, weight decay 0.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..config import TrainConfig

_TRAINABLE_BACKBONE = re.compile(r"^backbone\.(conv0|layer[234]_)")
LABELS = ("main", "backbone", "frozen")


def param_label(name: str) -> str:
    """'frozen' | 'backbone' | 'main' for a parameter name of the port."""
    if name.startswith("backbone."):
        return "backbone" if _TRAINABLE_BACKBONE.match(name) else "frozen"
    return "main"


def label_params(model: torch.nn.Module) -> Dict[str, List[torch.nn.Parameter]]:
    """The model's parameters by label, in the model's order."""
    groups: Dict[str, List[torch.nn.Parameter]] = {label: [] for label in LABELS}
    for name, p in model.named_parameters():
        groups[param_label(name)].append(p)
    return groups


def step_lr(base_lr: float, lr_drop: int, steps_per_epoch: int, gamma: float = 0.1):
    """torch StepLR semantics in updates: lr * gamma^(epoch // lr_drop)."""

    def sched(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        return base_lr * gamma ** (epoch // lr_drop)

    return sched


def cosine_lr(base_lr: float, total_epochs: int, steps_per_epoch: int,
              min_ratio: float = 0.0, warmup_epochs: float = 0.0):
    """Cosine decay over epochs with an optional linear warmup."""

    def sched(step: int) -> float:
        epoch = step / max(1, steps_per_epoch)
        warm = min(max(epoch / warmup_epochs, 0.0), 1.0) if warmup_epochs > 0 else 1.0
        t = min(max((epoch - warmup_epochs) / max(1, total_epochs - warmup_epochs), 0.0), 1.0)
        return base_lr * warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * t)))

    return sched


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm when their global norm is
    not below ``max_norm`` (optax's rule); returns the norm.  No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class SEDTOptimizer:
    """Clip by global norm, then AdamW over the ``main`` and ``backbone``
    groups, with averaging accumulation over ``accumulate`` steps.

    Call :meth:`step` after each backward.  It counts the micro-step; on
    every ``accumulate``-th one it averages the summed gradients, clips them,
    sets each group's lr from its schedule at the update count, updates and
    zeroes the gradients.
    """

    def __init__(self, groups: Dict[str, List[torch.nn.Parameter]],
                 schedules: Dict[str, Callable[[int], float]], weight_decay: float,
                 clip_max_norm: float, accumulate: int = 1):
        labels = [label for label in ("main", "backbone") if groups[label]]
        self.params = [p for label in labels for p in groups[label]]
        self.schedules = [schedules[label] for label in labels]
        self.adamw = torch.optim.AdamW(
            [{"params": groups[label], "lr": schedules[label](0)} for label in labels],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
            fused=self.params[0].is_cuda)
        self.clip_max_norm = clip_max_norm
        self.accumulate = accumulate
        self.micro_steps = 0  # calls of step()
        self.updates = 0  # optimizer updates: the schedules' count

    def step(self) -> None:
        self.micro_steps += 1
        if self.micro_steps % self.accumulate:
            return
        for p in self.params:  # every leaf decays on every update, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.accumulate > 1:
            torch._foreach_div_(grads, float(self.accumulate))
        clip_by_global_norm_(grads, self.clip_max_norm)
        for group, sched in zip(self.adamw.param_groups, self.schedules):
            group["lr"] = sched(self.updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=False)
        self.updates += 1

    def state_dict(self) -> Dict:
        """AdamW's state and the two counts; a checkpoint keeps it for
        ``--resume``."""
        return {"adamw": self.adamw.state_dict(), "micro_steps": self.micro_steps,
                "updates": self.updates}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s output into an optimizer built over
        the same parameters, on their device (AdamW moves its moments there)."""
        self.adamw.load_state_dict(state["adamw"])
        self.micro_steps = int(state["micro_steps"])
        self.updates = int(state["updates"])


def make_optimizer(model: torch.nn.Module, tcfg: TrainConfig, steps_per_epoch: int,
                   schedule: str = "step", fixed_lr: Optional[float] = None) -> SEDTOptimizer:
    """The JAX package's ``make_optimizer`` for the port's model; freezes the
    ``frozen`` group (``requires_grad=False``).  ``fixed_lr`` is the
    fine-tune stage's constant lr; ``tcfg.adjust_lr=False`` keeps each
    group's base lr."""
    groups = label_params(model)
    for p in groups["frozen"]:
        p.requires_grad_(False)

    def make_sched(base: float):
        if fixed_lr is not None:
            return lambda _: fixed_lr
        if not tcfg.adjust_lr:
            return lambda _: base
        if schedule == "cosine":
            return cosine_lr(base, tcfg.epochs, steps_per_epoch)
        return step_lr(base, tcfg.lr_drop, steps_per_epoch, tcfg.lr_drop_gamma)

    return SEDTOptimizer(
        groups, {"main": make_sched(tcfg.lr), "backbone": make_sched(tcfg.lr_backbone)},
        tcfg.weight_decay, tcfg.clip_max_norm, tcfg.accumulating_gradient_steps)


def make_audio_tag_optimizer(model: torch.nn.Module, lr: float, lr_drop: int,
                             steps_per_epoch: int, clip_max_norm: float) -> SEDTOptimizer:
    """The audio-tag trainer's ``optax.chain(clip_by_global_norm,
    adam(exponential_decay(lr, lr_drop * steps_per_epoch, 0.1,
    staircase=True)))``: one group of every parameter of ``model``, nothing
    frozen, so every leaf counts in the clip's norm; no weight decay, so the
    AdamW is Adam."""
    return SEDTOptimizer({"main": list(model.parameters()), "backbone": []},
                         {"main": step_lr(lr, lr_drop, steps_per_epoch)}, 0.0, clip_max_norm)


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float) -> None:
    """Mean-teacher EMA step in place: ema = decay * ema + (1 - decay) * params."""
    ema_params = list(ema_params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, list(params), alpha=1.0 - decay)
