"""Batched Hungarian matching between queries and dense targets.

Counterpart of the JAX package's ``ops/matcher.py``: the matching cost, the
LSAP dispatch to kernels K1 and K2 (:mod:`.hungarian`), the decoding of
assignments into query/target maps, the relaxed second stage of the
fine-tune matching and the per-query loss coefficients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import box_ops
from .hungarian import lsap

# Dummy-cell cost.  Real costs are clamped to [-REAL_CLAMP, REAL_CLAMP]; with
# at most 64 rows, BIG > 2 * N * REAL_CLAMP makes the solver maximise the
# number of real matches before minimising real cost.
REAL_CLAMP = 100.0
BIG = 1.0e4
INF = 1.0e18


class MatchResult(NamedTuple):
    """Dense assignment between queries and targets; leading dims [.., B]."""

    tgt_for_query: torch.Tensor  # [.., Q] int32 target per query (-1: none)
    query_matched: torch.Tensor  # [.., Q] bool
    query_for_tgt: torch.Tensor  # [.., M] int32 query per target (-1: none)
    tgt_matched: torch.Tensor  # [.., M] bool
    coef: torch.Tensor  # [.., Q] per-matched-query loss coefficient
    num_boxes: torch.Tensor  # [..] sum of coef over matched queries


def compute_cost_matrix(
    pred_logits: torch.Tensor,  # [B, Q, C+1]
    pred_boxes: torch.Tensor,  # [B, Q, 2] (center, length)
    tgt_labels: torch.Tensor,  # [B, M] int
    tgt_boxes: torch.Tensor,  # [B, M, 2]
    tgt_valid: torch.Tensor,  # [B, M] bool
    cost_class: float,
    cost_bbox: float,
    cost_giou: float,
    focal: bool = False,
    alpha_fl: float = 0.5,
    gamma_fl: float = 1.0,
) -> torch.Tensor:
    """The [B, Q, M] matching cost; invalid target columns cost BIG."""
    if focal:
        prob = torch.sigmoid(pred_logits)
        neg = (1 - alpha_fl) * (prob**gamma_fl) * (-torch.log1p(-prob + 1e-8))
        pos = alpha_fl * ((1 - prob) ** gamma_fl) * (-torch.log(prob + 1e-8))
        cls_cost_full = pos - neg
    else:
        cls_cost_full = -torch.softmax(pred_logits, dim=-1)
    q = pred_logits.shape[1]
    idx = tgt_labels.long()[:, None, :].expand(-1, q, -1)
    cls_cost = cls_cost_full.gather(-1, idx)  # [B, Q, M]

    pred_se = box_ops.box_cl_to_se(pred_boxes)
    tgt_se = box_ops.box_cl_to_se(tgt_boxes)
    l1 = box_ops.pairwise_l1_se(pred_se, tgt_se)
    giou = box_ops.generalized_box_iou(pred_se, tgt_se)

    cost = cost_bbox * l1 + cost_class * cls_cost + cost_giou * (-giou)
    cost = cost.clamp(-REAL_CLAMP, REAL_CLAMP)
    return torch.where(tgt_valid[:, None, :], cost, BIG)


def _square_pad(cost: torch.Tensor) -> torch.Tensor:
    """Pad a [B, Q, M] cost to square [B, N, N] with dummy cells at BIG."""
    b, q, m = cost.shape
    n = max(q, m)
    out = torch.full((b, n, n), BIG, dtype=cost.dtype, device=cost.device)
    out[:, :q, :m] = cost
    return out


def solve_lsap(cost_sq: torch.Tensor) -> torch.Tensor:
    """Square batched LSAP over arbitrary leading dims: [..., N, N] -> [..., N]."""
    n = cost_sq.shape[-1]
    out = lsap(cost_sq.detach().float().reshape(-1, n, n).contiguous())
    return out.reshape(cost_sq.shape[:-2] + (n,))


def _solve_rect_flat(cost: torch.Tensor) -> torch.Tensor:
    """Rectangular LSAP [B, Q, M] (Q <= M) -> [B, M] row-for-column, -1 on
    the M - Q free columns.  One launch for the whole batch: kernel K1 up to
    31 columns, K2 beyond (their plain version on the CPU)."""
    return lsap(cost.detach().float().contiguous())


def assign(cost: torch.Tensor, tgt_valid: torch.Tensor):
    """Solve the batched LSAP and decode real query<->target pairs.

    cost [B, Q, M] with invalid columns already at BIG; tgt_valid [B, M].
    Returns (tgt_for_query [B, Q] int32, query_matched [B, Q] bool,
    query_for_tgt [B, M] int32, tgt_matched [B, M] bool).
    """
    b, q, m = cost.shape
    dev = cost.device
    if q <= m:
        cols = _solve_rect_flat(cost).long()  # [B, M]: query per target, -1 free
    else:
        # transpose so rows <= cols, then invert target-per-query to
        # query-per-target
        rows = _solve_rect_flat(cost.transpose(1, 2)).long()  # [B, Q]
        cols = torch.full((b, m), -1, dtype=torch.long, device=dev)
        qs = torch.arange(q, device=dev).expand(b, q)
        cols.scatter_reduce_(1, rows.clamp(min=0), torch.where(rows >= 0, qs, -1), "amax")
    tgt_matched = tgt_valid & (cols >= 0) & (cols < q)
    query_for_tgt = torch.where(tgt_matched, cols, -1)

    # invert: per query, which target (each query holds at most one target)
    tgt_for_query = torch.full((b, q + 1), -1, dtype=torch.long, device=dev)
    slot = torch.where(tgt_matched, query_for_tgt, q)  # unmatched -> spare slot q
    m_ids = torch.arange(m, device=dev).expand(b, m)
    tgt_for_query.scatter_reduce_(1, slot, torch.where(tgt_matched, m_ids, -1), "amax")
    tgt_for_query = tgt_for_query[:, :q]
    query_matched = tgt_for_query >= 0
    return (tgt_for_query.int(), query_matched, query_for_tgt.int(), tgt_matched)


def relaxed_assign(
    cost_loc: torch.Tensor,  # [B, Q, M] location-only cost (bbox + giou)
    tgt_valid: torch.Tensor,  # [B, M]
    tgt_for_query: torch.Tensor,  # [B, Q]
    query_matched: torch.Tensor,  # [B, Q]
    epsilon: float,
    alpha: float,
    rnd: torch.Tensor,  # [B, Q] uniform draws in [0, 1)
):
    """Second-stage matching of the fine-tune phase.

    Queries whose best location cost is below ``epsilon`` are reserved.  A
    Hungarian-matched query stays matched only if reserved; an unmatched
    reserved query joins its nearest target when its draw passes
    ``rnd <= alpha * num_gt / Q``.  Returns (tgt_for_query, query_matched).
    """
    q = cost_loc.shape[1]
    masked = torch.where(tgt_valid[:, None, :], cost_loc, INF)
    best_cost, nearest_tgt = masked.min(dim=-1)  # [B, Q]; the first of equal minima
    num_gt = tgt_valid.sum(dim=-1).float()  # [B]
    reserved = best_cost < epsilon
    keep_matched = query_matched & reserved
    extra_pool = reserved & ~query_matched
    keep_prob = (alpha * num_gt / q)[:, None]
    extra_kept = extra_pool & (rnd <= keep_prob)
    new_tgt = torch.where(keep_matched, tgt_for_query.long(),
                          torch.where(extra_kept, nearest_tgt, -1))
    return new_tgt.int(), keep_matched | extra_kept


def compute_coef(
    tgt_for_query: torch.Tensor,  # [B, Q]
    query_matched: torch.Tensor,  # [B, Q]
    tgt_ratio: Optional[torch.Tensor],  # [B, M] per-target weight or None
    normalize: bool,
    M: int,
) -> torch.Tensor:
    """Per-query loss coefficient, 0 for unmatched queries."""
    t_safe = tgt_for_query.long().clamp(0, M - 1)
    if normalize:
        onehot = F.one_hot(t_safe, M).float() * query_matched[..., None]
        per_tgt = 1.0 / onehot.sum(dim=1).clamp(min=1.0)
        coef = per_tgt.gather(-1, t_safe)
    elif tgt_ratio is not None:
        coef = tgt_ratio.float().gather(-1, t_safe)
    else:
        coef = torch.ones(tgt_for_query.shape, dtype=torch.float32, device=tgt_for_query.device)
    return torch.where(query_matched, coef, 0.0)


def match(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    tgt_labels: torch.Tensor,
    tgt_boxes: torch.Tensor,
    tgt_valid: torch.Tensor,
    tgt_ratio: Optional[torch.Tensor] = None,
    *,
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal: bool = False,
    alpha_fl: float = 0.5,
    gamma_fl: float = 1.0,
    fine_tune: bool = False,
    normalize: bool = False,
    epsilon: float = 0.0,
    alpha: float = 100.0,
    generator: Optional[torch.Generator] = None,
    rnd: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Cost build + LSAP (+ the relaxed stage under ``fine_tune``) +
    coefficients; no gradient flows through it.  The relaxed stage's [B, Q]
    uniform draws are ``rnd`` if given, else drawn from ``generator``."""
    with torch.no_grad():
        cost = compute_cost_matrix(
            pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
            cost_class, cost_bbox, cost_giou, focal, alpha_fl, gamma_fl,
        )
        tgt_for_query, query_matched, query_for_tgt, tgt_matched = assign(cost, tgt_valid)
        if fine_tune:
            pred_se = box_ops.box_cl_to_se(pred_boxes)
            tgt_se = box_ops.box_cl_to_se(tgt_boxes)
            cost_loc = (cost_bbox * box_ops.pairwise_l1_se(pred_se, tgt_se)
                        + cost_giou * -box_ops.generalized_box_iou(pred_se, tgt_se))
            if rnd is None:
                rnd = torch.rand(tgt_for_query.shape, generator=generator,
                                 device=pred_boxes.device)
            tgt_for_query, query_matched = relaxed_assign(
                cost_loc, tgt_valid, tgt_for_query, query_matched, epsilon, alpha, rnd)
        coef = compute_coef(tgt_for_query, query_matched, tgt_ratio, normalize,
                            tgt_labels.shape[-1])
    return MatchResult(
        tgt_for_query=tgt_for_query,
        query_matched=query_matched,
        query_for_tgt=query_for_tgt,
        tgt_matched=tgt_matched,
        coef=coef,
        num_boxes=coef.sum(-1),
    )
