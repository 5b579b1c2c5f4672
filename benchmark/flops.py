"""Analytic operation and byte counts of the benchmark's steps, from the
configuration's shapes alone.

FLOPs count the convolutions and matrix products of a training step, two
per multiply-add: every forward, and in the backward the input gradient of
each product whose input needs one and the weight gradient of each product
whose weight trains.  So the count is the model's work, whatever kernels
implement it; elementwise work, the matching (kernel K1) and the optimizer
are left out.  These are the rules ``torch.utils.flop_counter`` applies to
the aten products, which the tests hold the count against.

Bytes bound kernel K1 (the batched assignment): its f32 cost tensor read
once and its int32 assignment written once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .reference.params import PLANES, STAGES

# (part, multiply-adds, input gradient?, weight trains?)
Op = Tuple[str, int, bool, bool]


def _out(size: int, k: int, stride: int, pad: int, dil: int = 1) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def backbone_ops(n: int, h: int, w: int, frozen_stem: bool = True) -> Tuple[List[Op], Tuple[int, int]]:
    """ResNet-50 DC5 on [n, 1, h, w]: its convolutions and output size.  The
    input is data (conv0 takes no input gradient); conv1 and layer1 are
    frozen, so they take the input gradient only."""
    ops: List[Op] = [("backbone", n * h * w * 3 * 1, False, True)]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    ops.append(("backbone", n * h * w * 64 * 3 * 49, True, not frozen_stem))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for li, (blocks, p) in enumerate(zip(STAGES, PLANES)):
        trains = li > 0 or not frozen_stem
        for bi in range(blocks):
            stride = (1, 2, 2, 1)[li] if bi == 0 else 1
            dil = 2 if (li == 3 and bi > 0) else 1
            ho, wo = _out(h, 3, stride, dil, dil), _out(w, 3, stride, dil, dil)
            ops.append(("backbone", n * h * w * p * cin, True, trains))
            ops.append(("backbone", n * ho * wo * p * p * 9, True, trains))
            ops.append(("backbone", n * ho * wo * 4 * p * p, True, trains))
            if bi == 0:
                ops.append(("backbone", n * ho * wo * 4 * p * cin, True, trains))
            h, w, cin = ho, wo, 4 * p
    return ops, (h, w)


def _linear(part: str, rows: int, din: int, dout: int) -> Op:
    return (part, rows * din * dout, True, True)


def _attention(rows_q: int, rows_k: int, n: int, sq: int, sk: int, d: int) -> List[Op]:
    """Four projections, then scores and the weighted sum, each a product of
    two operands that both take gradients."""
    return ([_linear("transformer", rows_q, d, d), _linear("transformer", rows_k, d, d),
             _linear("transformer", rows_k, d, d), _linear("transformer", rows_q, d, d)]
            + [("attention", n * sq * sk * d, True, True)] * 2)


def step_ops(config: Dict, batch: int) -> List[Op]:
    """Every product of one training step of ``config`` at ``batch`` clips."""
    m = config["model"]
    d, ff, t, f = m["hidden_dim"], m["dim_feedforward"], m["frames"], m["n_mels"]
    ops, (tp, fp) = backbone_ops(batch, t, f)
    s = tp * fp
    q_events = m["num_queries"]
    q = q_events + (1 if m["dec_at"] and not m["self_sup"] else 0)
    ops.append(_linear("input_proj", batch * s, 2048, d))
    for _ in range(m["enc_layers"]):
        ops += _attention(batch * s, batch * s, batch, s, s, d)
        ops += [_linear("transformer", batch * s, d, ff), _linear("transformer", batch * s, ff, d)]
    for _ in range(m["dec_layers"]):
        ops += _attention(batch * q, batch * q, batch, q, q, d)
        ops += _attention(batch * q, batch * s, batch, q, s, d)
        ops += [_linear("transformer", batch * q, d, ff), _linear("transformer", batch * q, ff, d)]
    rows = m["dec_layers"] * batch * q_events
    classes = 1 if m["self_sup"] else m["num_classes"]
    ops += [_linear("heads", rows, d, classes + 1), _linear("heads", rows, d, d),
            _linear("heads", rows, d, d), _linear("heads", rows, d, 2)]
    if m["dec_at"] and not m["self_sup"]:
        ops.append(_linear("heads", batch, d, classes))
    if m["self_sup"]:
        pt, pf = m["patch"]
        patch_ops, _ = backbone_ops(batch * m["num_patches"], pt, pf)
        ops += [("patch " + p, macs, dg, wg) for p, macs, dg, wg in patch_ops]
        ops.append(_linear("heads", batch * m["num_patches"], 2048, d))
        if m["feature_recon"]:
            ops += [_linear("heads", rows, d, d), _linear("heads", rows, d, 2048)]
    return ops


def count(ops: List[Op], backward: bool = True) -> Dict[str, float]:
    """FLOPs by part and in ``total``."""
    out: Dict[str, float] = {}
    for part, macs, dgrad, wgrad in ops:
        n = 1 + (dgrad + wgrad if backward else 0)
        out[part] = out.get(part, 0.0) + 2.0 * macs * n
    out["total"] = sum(out.values())
    return out


def step_flops(config: Dict, batch: int) -> float:
    """FLOPs of one training step of ``config`` at ``batch`` clips."""
    return count(step_ops(config, batch))["total"]


def k1_shape(config: Dict, batch: int) -> Tuple[int, int, int]:
    """The one K1 launch of a step: every decoder layer's problems of
    event queries against target slots."""
    m = config["model"]
    return m["dec_layers"] * batch, m["num_queries"], m["max_events"]


def k1_bytes(config: Dict, batch: int) -> int:
    """The cost tensor (f32) read once and the assignment (int32, a row per
    column) written once."""
    problems, rows, cols = k1_shape(config, batch)
    return problems * rows * cols * 4 + problems * cols * 4
