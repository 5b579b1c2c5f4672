"""Set-prediction criterion over dense targets (plain functions on tensors).

Counterpart of the JAX package's ``models/criterion.py`` for the paths the
evaluation step takes: the joint Hungarian solve over the final and aux
decoder layers, the classification, box, cardinality and audio-tag losses,
and the loss-weight dict.  ``num_boxes`` is clamped to >= 1 as in the JAX
package.  The patch-feature loss waits for SP-SEDT.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LossConfig, ModelConfig
from ..ops import box_ops
from ..ops.matcher import MatchResult, match


class DenseTargets(NamedTuple):
    """Fixed-capacity padded targets.  ``label_valid`` can exceed
    ``box_valid``: weak samples carry class labels without boxes."""

    labels: torch.Tensor  # [B, M] int
    boxes: torch.Tensor  # [B, M, 2] f32 (center, length) normalized
    box_valid: torch.Tensor  # [B, M] bool
    label_valid: torch.Tensor  # [B, M] bool
    ratio: torch.Tensor  # [B, M] f32 per-event mixup weight (1 when unmixed)
    orig_size: torch.Tensor  # [B] f32 clip length in seconds


def empty_targets(batch: int, max_events: int, seconds: float = 10.0,
                  device: torch.device | str = "cpu") -> DenseTargets:
    return DenseTargets(
        labels=torch.zeros((batch, max_events), dtype=torch.int32, device=device),
        boxes=torch.zeros((batch, max_events, 2), dtype=torch.float32, device=device),
        box_valid=torch.zeros((batch, max_events), dtype=torch.bool, device=device),
        label_valid=torch.zeros((batch, max_events), dtype=torch.bool, device=device),
        ratio=torch.ones((batch, max_events), dtype=torch.float32, device=device),
        orig_size=torch.full((batch,), seconds, dtype=torch.float32, device=device),
    )


def _gather_tgt(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, M, ...], idx [B, Q] (clipped to range) -> [B, Q, ...]."""
    idx = idx.long().clamp(0, arr.shape[1] - 1)
    idx = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
        idx.shape + arr.shape[2:])
    return arr.gather(1, idx)


def loss_labels(
    logits: torch.Tensor,  # [B, Q, C+1]
    targets: DenseTargets,
    mres: MatchResult,
    strong: torch.Tensor,  # [B] f32 0/1
    num_boxes: torch.Tensor,
    num_classes: int,
    eos_coef: float,
    fl: bool,
    alpha_fl: float,
    gamma_fl: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE (or sigmoid focal) classification loss; returns (loss_ce, class_error)."""
    tgt_cls = torch.where(
        mres.query_matched, _gather_tgt(targets.labels, mres.tgt_for_query).long(), num_classes
    )  # [B, Q]
    coef_b = torch.where(mres.query_matched, mres.coef, 1.0)
    empty_weight = torch.ones(num_classes + 1, device=logits.device)
    empty_weight[num_classes] = eos_coef

    if fl:
        onehot = F.one_hot(tgt_cls, num_classes + 1).float()
        p = torch.sigmoid(logits)
        bce = -(empty_weight * onehot * F.logsigmoid(logits)
                + (1.0 - onehot) * F.logsigmoid(-logits))
        p_t = p * onehot + (1 - p) * (1 - onehot)
        loss = bce * (1 - p_t) ** gamma_fl
        if alpha_fl >= 0:
            loss = (alpha_fl * onehot + (1 - alpha_fl) * (1 - onehot)) * loss
        ce = loss.sum(-1)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt_cls[..., None])[..., 0]
        ce = nll * empty_weight[tgt_cls]

    loss_ce = (ce * coef_b * strong[:, None]).sum() / num_boxes

    matched = mres.query_matched & (strong[:, None] > 0)
    correct = (logits.argmax(-1) == tgt_cls) & matched
    denom = matched.sum().clamp(min=1)
    class_error = 100.0 * (1.0 - correct.sum() / denom)
    return loss_ce, class_error.detach()


def loss_boxes(
    pred_boxes: torch.Tensor,  # [B, Q, 2]
    targets: DenseTargets,
    mres: MatchResult,
    strong: torch.Tensor,
    num_boxes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 + GIoU box regression over matched pairs."""
    tgt_box = _gather_tgt(targets.boxes, mres.tgt_for_query)
    pred_se = box_ops.box_cl_to_se(pred_boxes)
    tgt_se = box_ops.box_cl_to_se(tgt_box)
    l1 = box_ops.elementwise_l1_se(pred_se, tgt_se)
    giou = 1.0 - box_ops.elementwise_giou_se(pred_se, tgt_se)
    w = mres.coef * mres.query_matched * strong[:, None]
    return (l1 * w).sum() / num_boxes, (giou * w).sum() / num_boxes


def loss_cardinality(logits: torch.Tensor, targets: DenseTargets) -> torch.Tensor:
    """Logging-only |#non-empty predictions - #targets|, batch mean."""
    n_pred = (logits.argmax(-1) != logits.shape[-1] - 1).sum(-1)
    n_tgt = targets.label_valid.sum(-1)
    return (n_pred.float() - n_tgt.float()).abs().mean().detach()


def weak_ground_truth(targets: DenseTargets, num_classes: int) -> torch.Tensor:
    """Clip-level multi-hot gt with mixup-ratio accumulation, clamped to [0, 1]."""
    onehot = F.one_hot(targets.labels.long(), num_classes).float()  # [B, M, C]
    w = (targets.ratio * targets.label_valid)[..., None]
    return (onehot * w).sum(dim=1).clamp(0.0, 1.0)


def _bce(p: torch.Tensor, gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clamped p, elementwise BCE of probabilities p against gt)."""
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return p, -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))


def loss_weak(
    at: torch.Tensor,  # [B, C] sigmoid probabilities
    targets: DenseTargets,
    labeled: torch.Tensor,  # [B] f32 0/1
    fl: bool,
    alpha_fl: float,
    gamma_fl: float,
) -> torch.Tensor:
    """Clip-tag BCE over the labeled sub-batch."""
    c = at.shape[-1]
    gt = weak_ground_truth(targets, c)
    p, bce = _bce(at, gt)
    if fl:
        p_t = p * gt + (1 - p) * (1 - gt)
        loss = bce * (1 - p_t) ** gamma_fl
        if alpha_fl >= 0:
            loss = (alpha_fl * gt + (1 - alpha_fl) * (1 - gt)) * loss
        return (loss.sum(-1) * labeled).sum() / labeled.sum().clamp(min=1.0)
    return (bce * labeled[:, None]).sum() / (labeled.sum() * c).clamp(min=1.0)


def loss_weak_p(at_p: torch.Tensor, targets: DenseTargets, weak: torch.Tensor) -> torch.Tensor:
    """Pooling-branch BCE over the weak sub-batch only."""
    c = at_p.shape[-1]
    _, bce = _bce(at_p, weak_ground_truth(targets, c))
    return (bce * weak[:, None]).sum() / (weak.sum() * c).clamp(min=1.0)


def build_weight_dict(mcfg: ModelConfig, lcfg: LossConfig) -> Dict[str, float]:
    """Loss-name -> weight map."""
    wd = {
        "loss_ce": lcfg.ce_loss_coef,
        "loss_bbox": lcfg.bbox_loss_coef,
        "loss_giou": lcfg.giou_loss_coef,
    }
    if not mcfg.self_sup:
        if mcfg.dec_at:
            wd["loss_weak"] = lcfg.weak_loss_coef
        if mcfg.pooling:
            wd["loss_weak_p"] = lcfg.weak_loss_p_coef
    elif mcfg.feature_recon:
        wd["loss_feature"] = lcfg.feature_loss_coef
    if mcfg.aux_loss:
        for i in range(mcfg.dec_layers - 1):
            wd.update({f"{k}_{i}": v for k, v in list(wd.items()) if not k[-1].isdigit()})
    return wd


def _match_kw(lcfg: LossConfig, fl: bool) -> Dict:
    return dict(
        cost_class=lcfg.set_cost_class,
        cost_bbox=lcfg.set_cost_bbox,
        cost_giou=lcfg.set_cost_giou,
        focal=fl,
        alpha_fl=lcfg.alpha_fl,
        gamma_fl=lcfg.gamma_fl,
    )


def _stack_layers(outputs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final + aux layer predictions stacked: ([L, B, Q, C+1], [L, B, Q, 2])."""
    logits = torch.cat([outputs["pred_logits"][None], outputs["aux_logits"]], dim=0)
    boxes = torch.cat([outputs["pred_boxes"][None], outputs["aux_boxes"]], dim=0)
    return logits, boxes


def _repeat(targets: DenseTargets, n: int) -> DenseTargets:
    return DenseTargets(*(t.repeat((n,) + (1,) * (t.dim() - 1)) for t in targets))


def joint_match(
    outputs: Dict[str, torch.Tensor],
    targets: DenseTargets,
    lcfg: LossConfig,
    fl: bool = False,
) -> Tuple[MatchResult, Optional[MatchResult]]:
    """Plain matching of the final and all aux decoder layers in ONE batched
    LSAP solve: L layers x B clips problems, one launch of kernel K1.
    Returns (final-layer result [B, ..], aux results [A, B, ..] or None)."""
    kw = _match_kw(lcfg, fl)
    if "aux_logits" not in outputs:
        m = match(outputs["pred_logits"], outputs["pred_boxes"], targets.labels,
                  targets.boxes, targets.box_valid, targets.ratio, **kw)
        return m, None
    logits, boxes = _stack_layers(outputs)
    n_layers, b = logits.shape[:2]
    t = _repeat(targets, n_layers)
    m = match(logits.flatten(0, 1), boxes.flatten(0, 1), t.labels, t.boxes,
              t.box_valid, t.ratio, **kw)
    m = MatchResult(*(x.reshape((n_layers, b) + x.shape[1:]) for x in m))
    return MatchResult(*(x[0] for x in m)), MatchResult(*(x[1:] for x in m))


def set_criterion(
    outputs: Dict[str, torch.Tensor],
    targets: DenseTargets,
    strong_mask: Optional[torch.Tensor],  # [B] bool; None = no strong samples
    weak_mask: Optional[torch.Tensor],  # [B] bool or None
    mcfg: ModelConfig,
    lcfg: LossConfig,
    fine_tune: bool = False,
    normalize: bool = False,
    fl: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Optional[MatchResult]]:
    """Full criterion; returns (losses, final-layer match result).

    With aux outputs and plain matching the final and aux layers share one
    solve (:func:`joint_match`).  The final layer's ``num_boxes`` normalises
    the aux layers too.
    """
    b = outputs["pred_boxes"].shape[0]
    dev = outputs["pred_boxes"].device
    zeros = torch.zeros((b,), dtype=torch.float32, device=dev)
    strong = strong_mask.float() if strong_mask is not None else zeros
    weak = weak_mask.float() if weak_mask is not None else zeros
    labeled = (strong + weak).clamp(0.0, 1.0)
    num_classes = mcfg.num_classes if not mcfg.self_sup else 1

    match_kw = _match_kw(lcfg, fl)
    losses: Dict[str, torch.Tensor] = {}
    mres = None
    aux_mres = None
    num_boxes = torch.ones((), device=dev)
    has_aux = "aux_logits" in outputs
    if strong_mask is not None:
        if has_aux and not fine_tune and not normalize:
            mres, aux_mres = joint_match(outputs, targets, lcfg, fl)
        else:
            mres = match(
                outputs["pred_logits"], outputs["pred_boxes"], targets.labels,
                targets.boxes, targets.box_valid, targets.ratio,
                fine_tune=fine_tune, normalize=normalize, **match_kw,
            )
        num_boxes = (mres.num_boxes * strong).sum().clamp(min=1.0)
        lc, cerr = loss_labels(
            outputs["pred_logits"], targets, mres, strong, num_boxes,
            num_classes, lcfg.eos_coef, fl, lcfg.alpha_fl, lcfg.gamma_fl,
        )
        lb, lg = loss_boxes(outputs["pred_boxes"], targets, mres, strong, num_boxes)
        losses.update(loss_ce=lc, class_error=cerr, loss_bbox=lb, loss_giou=lg)
        losses["cardinality_error"] = loss_cardinality(outputs["pred_logits"], targets)

    if "at" in outputs:
        losses["loss_weak"] = loss_weak(
            outputs["at"], targets, labeled, fl, lcfg.alpha_fl, lcfg.gamma_fl
        )
    if "at_p" in outputs and weak_mask is not None:
        losses["loss_weak_p"] = loss_weak_p(outputs["at_p"], targets, weak)

    if has_aux and strong_mask is not None:
        for i in range(outputs["aux_logits"].shape[0]):
            logits_a, boxes_a = outputs["aux_logits"][i], outputs["aux_boxes"][i]
            if aux_mres is not None:
                m = MatchResult(*(x[i] for x in aux_mres))
            else:
                m = match(logits_a, boxes_a, targets.labels, targets.boxes,
                          targets.box_valid, targets.ratio, **match_kw)
            lc, _ = loss_labels(
                logits_a, targets, m, strong, num_boxes,
                num_classes, lcfg.eos_coef, fl, lcfg.alpha_fl, lcfg.gamma_fl,
            )
            lb, lg = loss_boxes(boxes_a, targets, m, strong, num_boxes)
            losses[f"loss_ce_{i}"] = lc
            losses[f"loss_bbox_{i}"] = lb
            losses[f"loss_giou_{i}"] = lg
            losses[f"cardinality_error_{i}"] = loss_cardinality(logits_a, targets)
    return losses, mres


def total_loss(losses: Dict[str, torch.Tensor], weight_dict: Dict[str, float]) -> torch.Tensor:
    """Weighted sum over the losses present in the weight dict."""
    return sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
