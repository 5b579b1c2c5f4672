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
  (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead); under
  tensor parallel the norm of the parameters cut over the model axis is
  summed over the model group;
* AdamW with two groups, ``main`` at ``lr`` and ``backbone`` at
  ``lr_backbone``, decaying every parameter of both on every update, as
  optax's ``add_decayed_weights`` does (so a parameter with no gradient gets a
  zero one, which ``torch.optim.AdamW`` would otherwise skip);
* StepLR or cosine schedules counted in optimizer updates, not micro-steps;
* averaging gradient accumulation (optax ``MultiSteps``): the update comes on
  every k-th step, from the mean of the k gradients;
* a step in two parts, so that a CUDA graph can replay the update: the host's
  (the counts, and each group's lr from its schedule written into a
  one-element tensor on the parameters' device) and the device's (the clip,
  AdamW reading that tensor, the zeroed gradients), which
  ``engine.make_train_step`` captures;
* the mean-teacher EMA;
* the audio-tag trainer's ``optax.chain(clip_by_global_norm, adam(staircase
  exponential decay))`` (:func:`make_audio_tag_optimizer`): the same
  optimizer over every parameter, no freeze, weight decay 0;
* AST's recipe (:func:`make_ast_optimizer`): ``torch.optim.Adam`` with
  betas (0.95, 0.999) and an L2 weight decay of 5e-7 added to the gradient,
  no clip, the lr halved every epoch from epoch 2 (:func:`halving_lr`).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..config import TrainConfig
from .distribute import all_reduce_sum, model_group, model_world

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


def halving_lr(base_lr: float, start_epoch: int, steps_per_epoch: int):
    """AST's ``MultiStepLR(milestones=range(start_epoch, ...), gamma=0.5)``
    stepped once an epoch, in updates: the lr of epoch ``e`` (from 0) is
    ``base_lr * 0.5 ** max(0, e - start_epoch + 1)``."""

    def sched(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        return base_lr * 0.5 ** max(0, epoch - start_epoch + 1)

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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm when their global norm is
    not below ``max_norm`` (optax's rule); returns the norm.  No host sync.

    ``sharded`` flags the gradients that are this rank's slice of a
    parameter cut over the model axis: with several model ranks their
    squared norms are summed over the model group (one ``all_reduce``) and
    the replicated ones counted once, so every rank clips by the one global
    norm, not by its own."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is not None and any(sharded) and model_world() > 1:
        cut = torch.tensor(sharded, device=norms.device)
        sq = norms.square()
        norm = torch.sqrt(all_reduce_sum(torch.where(cut, sq, 0.0).sum(), group=model_group())
                          + torch.where(cut, 0.0, sq).sum())
    else:
        norm = torch.linalg.vector_norm(norms)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class SEDTOptimizer:
    """Clip by global norm, then AdamW over the ``main`` and ``backbone``
    groups, with averaging accumulation over ``accumulate`` steps.

    Call :meth:`step` after each backward: :meth:`advance`, the host's part,
    then on an update step :meth:`update`, the device's.  ``advance`` counts
    the micro-step; on every ``accumulate``-th one it sets each group's lr
    from its schedule at the update count, on the host and in the group's
    one-element tensor ``lr`` on the parameters' device.  ``update`` averages
    the summed gradients, clips them, runs AdamW at the tensors' lr and
    zeroes the gradients, with no host sync and no host value that changes
    from step to step, so a CUDA graph captures it once and replays it after
    each ``advance``.  The tensors are f32 where the fused CUDA kernel reads
    them (it reads a float) and f64 elsewhere, so that the CPU's AdamW
    computes with the schedule's own double.  ``clip_max_norm=None`` skips
    the clip; ``decoupled=False`` makes the torch optimizer (``adamw``) an
    Adam whose weight decay is added to the gradient (L2) instead of AdamW's.
    """

    def __init__(self, groups: Dict[str, List[torch.nn.Parameter]],
                 schedules: Dict[str, Callable[[int], float]], weight_decay: float,
                 clip_max_norm: Optional[float], accumulate: int = 1,
                 betas: Tuple[float, float] = (0.9, 0.999), decoupled: bool = True):
        labels = [label for label in ("main", "backbone") if groups[label]]
        self.params = [p for label in labels for p in groups[label]]
        # the parameters cut over the model axis (parallel.mesh.shard_model)
        self.sharded = [getattr(p, "model_shard_dim", None) is not None for p in self.params]
        self.schedules = [schedules[label] for label in labels]
        fused = self.params[0].is_cuda
        opt = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.adamw = opt(
            [{"params": groups[label], "lr": schedules[label](0)} for label in labels],
            betas=betas, eps=1e-8, weight_decay=weight_decay, fused=fused)
        lr_dtype = torch.float32 if fused else torch.float64
        self.lr = [torch.tensor(sched(0), dtype=lr_dtype, device=self.params[0].device)
                   for sched in self.schedules]
        self.clip_max_norm = clip_max_norm
        self.accumulate = accumulate
        self.micro_steps = 0  # calls of step()
        self.updates = 0  # optimizer updates: the schedules' count

    def step(self) -> None:
        if self.advance():
            self.update()

    def advance(self) -> bool:
        """The host's part of a step: counts the micro-step and, on an update
        step, sets each group's lr (host value and device tensor, the tensor
        by a launch on the current stream) and counts the update.  Returns
        whether this step updates."""
        self.micro_steps += 1
        if self.micro_steps % self.accumulate:
            return False
        for group, sched, lr in zip(self.adamw.param_groups, self.schedules, self.lr):
            group["lr"] = sched(self.updates)
            lr.fill_(group["lr"])
        self.updates += 1
        return True

    def update(self) -> None:
        """The device's part of an update: every leaf gets a gradient (a zero
        one where it has none) and decays, as in optax; the accumulated
        gradients are averaged and clipped; AdamW runs at the ``lr`` tensors
        (capturable while the stream captures); the gradients are zeroed in
        place, so a captured backward accumulates into the same tensors."""
        for p in self.params:  # every leaf decays on every update, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.accumulate > 1:
            torch._foreach_div_(grads, float(self.accumulate))
        if self.clip_max_norm is not None:
            clip_by_global_norm_(grads, self.clip_max_norm, self.sharded)
        groups = self.adamw.param_groups
        host_lr = [group["lr"] for group in groups]
        capturing = self.params[0].is_cuda and torch.cuda.is_current_stream_capturing()
        for group, lr in zip(groups, self.lr):
            group.update(lr=lr, capturable=capturing)
        try:
            self.adamw.step()
        finally:  # the groups keep host values, which state_dict saves
            for group, lr in zip(groups, host_lr):
                group.update(lr=lr, capturable=False)
        self.adamw.zero_grad(set_to_none=False)

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


AST_LR = 1e-5  # the AudioSet recipe's lr, --lr's default with --at_model ast
AST_BETAS = (0.95, 0.999)
AST_WEIGHT_DECAY = 5e-7
AST_HALVING_START = 2  # the first epoch (from 0) at half the lr


def make_ast_optimizer(model: torch.nn.Module, lr: float, steps_per_epoch: int) -> SEDTOptimizer:
    """AST's recipe (``src/traintest.py``): ``torch.optim.Adam(lr,
    weight_decay=5e-7, betas=(0.95, 0.999))`` over every parameter, no clip,
    the lr halved every epoch from epoch 2."""
    return SEDTOptimizer({"main": list(model.parameters()), "backbone": []},
                         {"main": halving_lr(lr, AST_HALVING_START, steps_per_epoch)},
                         AST_WEIGHT_DECAY, None, betas=AST_BETAS, decoupled=False)


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float) -> None:
    """Mean-teacher EMA step in place: ema = decay * ema + (1 - decay) * params."""
    ema_params = list(ema_params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, list(params), alpha=1.0 - decay)
