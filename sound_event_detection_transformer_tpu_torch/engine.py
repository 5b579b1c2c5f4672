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
  post-processing, with the same result dict;
* the mean-teacher step, ``make_semi_train_step``: the EMA teacher's
  pseudo-labels on the device (``get_pseudo_labels``: class-wise
  thresholds, a duration filter, the greedy ``same_class_nms``), one
  forward over the labeled and the student views, one joint Hungarian solve
  of the labeled and pseudo-labeled problems, and the EMA update; with
  ``adjust_threshold``, the host's per-epoch threshold adaptation.

The JAX package's frozen-leaf mask (``_frozen_param_mask`` /
``_swap_in_frozen``) becomes ``requires_grad=False`` on the frozen
parameters, which :func:`.parallel.optim.make_optimizer` sets and keeps out
of the optimizer.  The teacher is a second module: a copy of the student
without gradients, whose parameters (the frozen ones too) follow the
student's by the EMA.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import SEDTConfig
from .models import postprocess, resolve_device, set_criterion, total_loss
from .models.criterion import DenseTargets, joint_match
from .ops import augment
from .ops.matcher import MatchResult
from .ops.patches import extract_patches_device
from .parallel.optim import SEDTOptimizer, ema_update, make_optimizer


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


# ---------------------------------------------------------------------------
# Semi-supervised mean teacher
# ---------------------------------------------------------------------------


def _rank(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each row's indices by descending score, the invalid entries last; a
    stable sort, so that ties keep the index order (``jnp.argsort``'s)."""
    return torch.sort(-torch.where(valid, scores, -torch.inf), dim=-1, stable=True).indices


def same_class_nms(
    scores: torch.Tensor,  # [B, Q]
    labels: torch.Tensor,  # [B, Q] int
    boxes_cl: torch.Tensor,  # [B, Q, 2] (center, length) normalized
    valid: torch.Tensor,  # [B, Q] bool
) -> torch.Tensor:
    """Greedy same-class overlap suppression by score; returns the keep mask
    [B, Q].  In rank order, a valid candidate is dropped when an earlier
    kept event of its class overlaps it by more than 0.

    The [B, Q, Q] same-class-and-overlap matrix is built once, in rank
    order; then Q sequential steps over a [B, Q] keep tensor, a few
    launches each, with no host sync."""
    order = _rank(scores, valid)
    lab = labels.gather(1, order)
    box = boxes_cl.gather(1, order[..., None].expand(-1, -1, 2))
    s = box[..., 0] - box[..., 1] / 2
    e = box[..., 0] + box[..., 1] / 2
    ov = torch.minimum(e[:, :, None], e[:, None, :]) - torch.maximum(s[:, :, None], s[:, None, :])
    clash = (lab[:, :, None] == lab[:, None, :]) & (ov > 0)  # [B, Q, Q] in rank order
    valid_r = valid.gather(1, order)
    keep_r = torch.zeros_like(valid_r)
    for i in range(scores.shape[1]):
        # only candidates ranked before i can be kept yet
        keep_r[:, i] = valid_r[:, i] & ~(keep_r & clash[:, i]).any(-1)
    return torch.zeros_like(keep_r).scatter_(1, order, keep_r)


def get_pseudo_labels(
    tea_outputs: Dict[str, torch.Tensor],
    classwise_threshold: torch.Tensor,  # [C] f32
    orig_sizes: torch.Tensor,  # [B] seconds
    max_events: int,
) -> Tuple[DenseTargets, torch.Tensor]:
    """The teacher's predictions as dense pseudo targets.

    Audio tags ``at >= threshold`` gate the class scores (fusion strategy
    1); an event is kept when its score reaches its class's threshold, it
    lasts more than 0.2 s and ``same_class_nms`` keeps it.  The kept events
    fill ``max_events`` slots, the highest scores first.  Returns (targets
    with ``ratio`` 1, the kept events per class [C] f32)."""
    at = tea_outputs.get("at")
    audio_tags = (at >= classwise_threshold[None, :]).float() if at is not None else None
    pp = postprocess(tea_outputs, orig_sizes, audio_tags=audio_tags, at_m=1, is_semi=True,
                     threshold=None)
    q = pp.scores.shape[1]
    thr = classwise_threshold[pp.labels.long()]  # [B, Q]
    keep = (pp.scores >= thr) & (pp.boxes[..., 1] > 0.2 / orig_sizes[:, None])
    keep = keep & same_class_nms(pp.scores, pp.labels, pp.boxes, keep)

    m = max_events
    rank = _rank(pp.scores, keep)[:, :min(q, m)]
    pad = m - rank.shape[1]
    labels = F.pad(pp.labels.gather(1, rank), (0, pad))
    boxes = F.pad(pp.boxes.gather(1, rank[..., None].expand(-1, -1, 2)), (0, 0, 0, pad))
    valid = F.pad(keep.gather(1, rank), (0, pad))
    counts = (F.one_hot(labels.long(), classwise_threshold.shape[0]).float()
              * valid[..., None]).sum(dim=(0, 1))
    targets = DenseTargets(
        labels=torch.where(valid, labels, 0),
        boxes=torch.where(valid[..., None], boxes, 0.0),
        box_valid=valid,
        label_valid=valid,
        ratio=torch.ones(valid.shape, dtype=torch.float32, device=valid.device),
        orig_size=orig_sizes,
    )
    return targets, counts


def adjust_threshold(pseudo_counts: np.ndarray, origin_threshold: np.ndarray,
                     true_distribution: np.ndarray) -> np.ndarray:
    """Class-wise thresholds adapted toward the class prior from an epoch's
    pseudo counts, in float64 on the host: clip((share / prior) ** 0.7 *
    origin, 0.45, 0.7); the origin thresholds when nothing was counted."""
    total = pseudo_counts.sum()
    if total <= 0:
        return origin_threshold
    ratio = pseudo_counts / total
    adjust = (ratio / true_distribution) ** 0.7
    return np.clip(adjust * origin_threshold, 0.45, 0.7)


def _rows(out: Dict[str, torch.Tensor], rows: slice) -> Dict[str, torch.Tensor]:
    """The forward's outputs for the clips ``rows``; ``aux_*`` stack the
    decoder layers in front, so their clips are axis 1."""
    return {k: (v[:, rows] if k.startswith("aux_") else v[rows]) for k, v in out.items()}


def _cut(m: MatchResult, rows: slice, axis: int = 0) -> MatchResult:
    return MatchResult(*(x[(slice(None),) * axis + (rows,)] for x in m))


def make_semi_train_step(
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    fine_tune: bool = False,
    normalize: bool = False,
    fl: bool = False,
    n_labeled: Optional[int] = None,
    device: Optional[torch.device | str] = None,
) -> Callable:
    """The mean-teacher step: ``step(state, teacher, teacher_feats,
    student_feats, pad_mask, targets, strong, weak, unlabel,
    classwise_threshold, generator, do_ema) -> (metrics, counts)``, with the
    device it runs on as ``step.device``.

    ``state`` is the student's :class:`TrainState`; ``teacher`` the EMA
    model (no gradients, always deterministic).  ``teacher_feats`` are the
    clean views, ``student_feats`` the noisy ones; the batch is labeled
    rows first: with ``n_labeled`` the supervised branch runs on rows
    ``[:n_labeled]`` and the teacher and student on the rest, without it
    every branch runs on the whole batch.  ``classwise_threshold`` ([C] f32
    on the device) sets the pseudo-labels; ``generator`` draws the mixups
    (labeled, then labeled into unlabeled), the dropout masks and the
    relaxed matching, in that order; ``do_ema`` (a host bool) applies
    ``teacher = d * teacher + (1 - d) * student`` to every parameter after
    the update.  One forward runs over the labeled and student views
    together; under plain matching their labeled and pseudo-labeled
    problems share one Hungarian solve, and the two criteria each normalise
    by their own strong rows.  Returns ``{"loss", "sup_*", "unsup_*"}`` and
    the pseudo events per class (zero when no row is unlabeled), as tensors
    on the device; no host sync.
    """
    dev = resolve_device(device)
    a = cfg.augment
    me = cfg.model.max_events
    lab = slice(0, n_labeled) if n_labeled else slice(None)
    unl = slice(n_labeled, None) if n_labeled else slice(None)
    crit_kw = dict(fine_tune=fine_tune, normalize=normalize, fl=fl)

    def step(state: TrainState, teacher: torch.nn.Module, teacher_feats, student_feats,
             pad_mask, targets: DenseTargets, strong, weak, unlabel,
             classwise_threshold: torch.Tensor, generator: Optional[torch.Generator],
             do_ema: bool):
        model, optimizer = state
        to = lambda t: t.to(dev, non_blocking=True)
        teacher_feats, student_feats, pad_mask = map(to, (teacher_feats, student_feats, pad_mask))
        targets = DenseTargets(*(to(t) for t in targets))
        strong, weak, unlabel = map(to, (strong, weak, unlabel))
        pad_lab, pad_unl = pad_mask[lab], pad_mask[unl]

        # the supervised branch's inputs: the clean labeled views, mixed
        feats_l = teacher_feats[lab]
        targets_l = DenseTargets(*(t[lab] for t in targets))
        strong_l, weak_l = strong[lab], weak[lab]
        if a.mix_up_ratio > 0:
            labeled_l = strong_l | weak_l
            feats_l, targets_l, strong_l, weak_l = augment.mixup(
                feats_l, targets_l, strong_l, weak_l, generator, mix_up_ratio=a.mix_up_ratio,
                alpha=1.0, max_events=me)
            # mixup never promotes an unlabeled row into the loss
            strong_l, weak_l = strong_l & labeled_l, weak_l & labeled_l

        # the teacher's pseudo-labels on the clean unlabeled views
        with torch.no_grad():
            tea_out = teacher(teacher_feats[unl], pad_unl, deterministic=True)
            pseudo, counts = get_pseudo_labels(tea_out, classwise_threshold,
                                               targets.orig_size[unl], me)
        unlabel_u = unlabel[unl]
        counts = torch.where(unlabel_u.any(), counts, 0.0)
        student_in = student_feats[unl]
        if a.mix_up_ratio > 0:
            student_in, pseudo = augment.mixup_label_unlabel(
                feats_l, student_in, targets_l, pseudo, generator,
                mix_up_ratio=a.mix_up_ratio, alpha=1.0, max_events=me)

        with torch.enable_grad():
            n_l = feats_l.shape[0]
            both = model(torch.cat([feats_l, student_in]), torch.cat([pad_lab, pad_unl]),
                         deterministic=False, generator=generator)
            sup_out, st_out = _rows(both, slice(0, n_l)), _rows(both, slice(n_l, None))
            pre_sup = pre_un = None
            if not fine_tune and not normalize:
                # the labeled and pseudo-labeled problems of every decoder
                # layer in one solve, then cut at n_l
                m_all, aux_all = joint_match(
                    both, DenseTargets(*(torch.cat([x, y]) for x, y in zip(targets_l, pseudo))),
                    cfg.loss, fl)
                cut = lambda rows: (_cut(m_all, rows),
                                    None if aux_all is None else _cut(aux_all, rows, axis=1))
                pre_sup, pre_un = cut(slice(0, n_l)), cut(slice(n_l, None))
            sup_losses, _ = set_criterion(sup_out, targets_l, strong_l, weak_l, cfg.model,
                                          cfg.loss, generator=generator, precomputed=pre_sup,
                                          **crit_kw)
            # every unlabeled row is strong against its pseudo boxes
            un_losses, _ = set_criterion(st_out, pseudo, unlabel_u, None, cfg.model, cfg.loss,
                                         generator=generator, precomputed=pre_un, **crit_kw)
            loss = total_loss(sup_losses, weight_dict) + total_loss(un_losses, weight_dict)
            loss.backward()
        optimizer.step()
        if do_ema:
            ema_update(teacher.parameters(), model.parameters(), cfg.train.ema_decay)
        metrics = {"loss": loss.detach()}
        metrics.update({f"sup_{k}": v.detach() for k, v in sup_losses.items()})
        metrics.update({f"unsup_{k}": v.detach() for k, v in un_losses.items()})
        return metrics, counts

    step.device = dev
    return step


def make_teacher(model: torch.nn.Module) -> torch.nn.Module:
    """The EMA teacher: a copy of the student (parameters and FrozenBN
    buffers, on the student's device) without gradients."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher
