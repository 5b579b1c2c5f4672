"""Set-prediction criterion over dense targets (plain functions on tensors).

Counterpart of the JAX package's ``models/criterion.py``: the Hungarian
matching of the final and aux decoder layers (one joint solve for plain
matching; under ``fine_tune`` or ``normalize`` one solve for the final layer
and one for all aux layers), the classification, box, cardinality and
audio-tag losses, SP-SEDT's patch-feature reconstruction loss, and the
loss-weight dict.  Gradients flow from the losses into the logits, boxes,
audio tags and features (the reconstruction target's too), never through
the matching.  ``num_boxes`` is clamped to >= 1 as in the JAX package.

Over several processes (``set_criterion(reduce=...)``) each rank holds its
share of the global batch, and every denominator that the JAX package takes
over the whole batch (``num_boxes``, the labeled and weak row counts,
``class_error``'s matched count) is summed over the ranks before its clamp.
Each rank's losses are then its partials of the global losses: summed over
the ranks they give the JAX package's values.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
    matched_total: Optional[torch.Tensor] = None,
    world: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE (or sigmoid focal) classification loss; returns (loss_ce, class_error).
    ``matched_total``: the matched strong queries of the global batch (this
    batch's when None); with ``world`` ranks ``class_error`` is then this
    rank's partial."""
    tgt_cls = torch.where(
        mres.query_matched, _gather_tgt(targets.labels, mres.tgt_for_query).long(), num_classes
    )  # [B, Q]
    coef_b = torch.where(mres.query_matched, mres.coef, 1.0)
    # the no-object class weighs eos_coef: a fill on the device (an item write
    # copies its value from the host, which a CUDA graph cannot capture)
    empty_weight = F.pad(torch.ones(num_classes, device=logits.device), (0, 1), value=eos_coef)

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
    denom = (matched.sum() if matched_total is None else matched_total).clamp(min=1)
    class_error = 100.0 * (1.0 / world - correct.sum() / denom)
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


def loss_cardinality(logits: torch.Tensor, targets: DenseTargets, world: int = 1) -> torch.Tensor:
    """Logging-only |#non-empty predictions - #targets|, batch mean (over
    ``world`` ranks of equal batches, this rank's partial: its mean / world)."""
    n_pred = (logits.argmax(-1) != logits.shape[-1] - 1).sum(-1)
    n_tgt = targets.label_valid.sum(-1)
    return ((n_pred.float() - n_tgt.float()).abs().mean() / world).detach()


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
    n_labeled: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Clip-tag BCE over the labeled sub-batch, divided by ``n_labeled``
    (the global batch's labeled rows; this batch's when None)."""
    c = at.shape[-1]
    gt = weak_ground_truth(targets, c)
    p, bce = _bce(at, gt)
    n = labeled.sum() if n_labeled is None else n_labeled
    if fl:
        p_t = p * gt + (1 - p) * (1 - gt)
        loss = bce * (1 - p_t) ** gamma_fl
        if alpha_fl >= 0:
            loss = (alpha_fl * gt + (1 - alpha_fl) * (1 - gt)) * loss
        return (loss.sum(-1) * labeled).sum() / n.clamp(min=1.0)
    return (bce * labeled[:, None]).sum() / (n * c).clamp(min=1.0)


def loss_weak_p(at_p: torch.Tensor, targets: DenseTargets, weak: torch.Tensor,
                n_weak: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooling-branch BCE over the weak sub-batch only, divided by
    ``n_weak`` (the global batch's weak rows; this batch's when None)."""
    c = at_p.shape[-1]
    _, bce = _bce(at_p, weak_ground_truth(targets, c))
    n = weak.sum() if n_weak is None else n_weak
    return (bce * weak[:, None]).sum() / (n * c).clamp(min=1.0)


def loss_feature(
    pred_feature: torch.Tensor,  # [B, Q, Cb]
    gt_feature: torch.Tensor,  # [B, P, Cb]
    mres: MatchResult,
    strong: torch.Tensor,
    num_boxes: torch.Tensor,
) -> torch.Tensor:
    """Normalised-MSE patch-feature reconstruction over the matched queries:
    each vector divided by max(its norm, 1e-12), in its own dtype.  The target
    keeps its gradient (no detach), as in the JAX package."""
    tgt = _gather_tgt(gt_feature, mres.tgt_for_query)  # [B, Q, Cb]
    norm = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-12)
    mse = ((norm(pred_feature) - norm(tgt)) ** 2).sum(-1)  # [B, Q]
    w = mres.query_matched * strong[:, None]
    return (mse * w).sum() / num_boxes


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


def _match_layers(logits: torch.Tensor, boxes: torch.Tensor, targets: DenseTargets,
                  kw: Dict) -> MatchResult:
    """Plain matching of L stacked layers ([L, B, ..]) in ONE batched LSAP
    solve of L x B problems; the result has leading dims [L, B]."""
    n_layers, b = logits.shape[:2]
    t = _repeat(targets, n_layers)
    m = match(logits.flatten(0, 1), boxes.flatten(0, 1), t.labels, t.boxes,
              t.box_valid, t.ratio, **kw)
    return MatchResult(*(x.reshape((n_layers, b) + x.shape[1:]) for x in m))


def joint_match(
    outputs: Dict[str, torch.Tensor],
    targets: DenseTargets,
    lcfg: LossConfig,
    fl: bool = False,
) -> Tuple[MatchResult, Optional[MatchResult]]:
    """Plain matching of the final and all aux decoder layers in ONE batched
    LSAP solve: L layers x B clips problems, one launch of kernel K1 or K2.
    Returns (final-layer result [B, ..], aux results [A, B, ..] or None);
    :func:`set_criterion` takes the pair as ``precomputed``, so several
    criterion calls can share one solve (the semi step's labeled and
    pseudo-labeled problems)."""
    kw = _match_kw(lcfg, fl)
    if "aux_logits" not in outputs:
        m = match(outputs["pred_logits"], outputs["pred_boxes"], targets.labels,
                  targets.boxes, targets.box_valid, targets.ratio, **kw)
        return m, None
    m = _match_layers(*_stack_layers(outputs), targets, kw)
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
    generator: Optional[torch.Generator] = None,
    precomputed: Optional[Tuple[MatchResult, Optional[MatchResult]]] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    world: int = 1,
) -> Tuple[Dict[str, torch.Tensor], Optional[MatchResult]]:
    """Full criterion; returns (losses, final-layer match result).

    With aux outputs and plain matching the final and aux layers share one
    solve (:func:`joint_match`).  Under ``fine_tune`` or ``normalize`` the
    final layer is matched alone (its relaxed stage draws from
    ``generator``) and the aux layers, matched plainly as in the JAX
    package, share a second solve.  The final layer's ``num_boxes``
    normalises the aux layers too.  ``precomputed``: an externally solved
    ``(mres, aux_mres)`` pair (:func:`joint_match`) in place of the
    criterion's own solve; plain matching only.

    ``reduce`` (a sum over ``world`` ranks, each holding an equal share of
    the global batch): the denominators are summed over the ranks in one
    call before their clamp, and every loss is this rank's partial (module
    docstring).
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
        if precomputed is not None:
            if fine_tune or normalize:
                raise ValueError("a precomputed matching is plain matching: no fine_tune "
                                 "or normalize")
            mres, aux_mres = precomputed
        elif has_aux and not fine_tune and not normalize:
            mres, aux_mres = joint_match(outputs, targets, lcfg, fl)
        else:
            mres = match(
                outputs["pred_logits"], outputs["pred_boxes"], targets.labels,
                targets.boxes, targets.box_valid, targets.ratio,
                fine_tune=fine_tune, normalize=normalize, epsilon=lcfg.epsilon,
                alpha=lcfg.alpha, generator=generator, **match_kw,
            )
            if has_aux:
                aux_mres = _match_layers(outputs["aux_logits"], outputs["aux_boxes"],
                                         targets, match_kw)
    counts = {"labeled": labeled.sum(), "weak": weak.sum()}
    if mres is not None:
        counts["boxes"] = (mres.num_boxes * strong).sum()
        counts["matched"] = (mres.query_matched & (strong[:, None] > 0)).sum().float()
    if reduce is not None:  # one collective for every denominator
        counts = dict(zip(counts, reduce(torch.stack(list(counts.values())))))
    if mres is not None:
        num_boxes = counts["boxes"].clamp(min=1.0)
        lc, cerr = loss_labels(
            outputs["pred_logits"], targets, mres, strong, num_boxes,
            num_classes, lcfg.eos_coef, fl, lcfg.alpha_fl, lcfg.gamma_fl,
            matched_total=counts["matched"] if reduce is not None else None, world=world,
        )
        lb, lg = loss_boxes(outputs["pred_boxes"], targets, mres, strong, num_boxes)
        losses.update(loss_ce=lc, class_error=cerr, loss_bbox=lb, loss_giou=lg)
        losses["cardinality_error"] = loss_cardinality(outputs["pred_logits"], targets, world)
        if "pred_feature" in outputs:
            losses["loss_feature"] = loss_feature(outputs["pred_feature"],
                                                  outputs["gt_feature"], mres, strong, num_boxes)

    if "at" in outputs:
        losses["loss_weak"] = loss_weak(
            outputs["at"], targets, labeled, fl, lcfg.alpha_fl, lcfg.gamma_fl,
            counts["labeled"] if reduce is not None else None,
        )
    if "at_p" in outputs and weak_mask is not None:
        losses["loss_weak_p"] = loss_weak_p(outputs["at_p"], targets, weak,
                                            counts["weak"] if reduce is not None else None)

    if has_aux and strong_mask is not None:
        for i in range(outputs["aux_logits"].shape[0]):
            logits_a, boxes_a = outputs["aux_logits"][i], outputs["aux_boxes"][i]
            m = MatchResult(*(x[i] for x in aux_mres))
            lc, _ = loss_labels(
                logits_a, targets, m, strong, num_boxes,
                num_classes, lcfg.eos_coef, fl, lcfg.alpha_fl, lcfg.gamma_fl,
            )
            lb, lg = loss_boxes(boxes_a, targets, m, strong, num_boxes)
            losses[f"loss_ce_{i}"] = lc
            losses[f"loss_bbox_{i}"] = lb
            losses[f"loss_giou_{i}"] = lg
            losses[f"cardinality_error_{i}"] = loss_cardinality(logits_a, targets, world)
            if "aux_feature" in outputs:
                losses[f"loss_feature_{i}"] = loss_feature(
                    outputs["aux_feature"][i], outputs["gt_feature"], m, strong, num_boxes)
    return losses, mres


def total_loss(losses: Dict[str, torch.Tensor], weight_dict: Dict[str, float]) -> torch.Tensor:
    """Weighted sum over the losses present in the weight dict."""
    return sum(losses[k] * w for k, w in weight_dict.items() if k in losses)
