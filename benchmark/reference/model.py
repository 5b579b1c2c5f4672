"""Plain PyTorch SEDT and SP-SEDT training steps: the yardstick that decides
``correct``.

Written from the published description and the configuration files under
``benchmark/configs``, with plain ``torch`` operations and nothing of the
program under test: the forward (ResNet-50 DC5 with frozen batch norm, the
sine positional encoding, the pre-norm transformer with dropout, the heads;
SP-SEDT's crops, patch backbone pass, patch queries and feature
reconstruction), the Hungarian matching of every decoder layer
(``scipy.optimize.linear_sum_assignment``), the set loss, the backward, the
clip by global norm and AdamW.

Dropout masks and SP-SEDT's query keep mask are drawn from a
``torch.Generator`` seeded as the trainer's, with the same shapes in the
same order (each attention's probabilities, each residual branch, each FFN
hidden layer, layer by layer; the keep mask before the transformer), so the
reference draws the masks the program draws.  The step runs in blocks of
rows (:class:`Draws` keeps each whole-batch draw for the later blocks), its
loss normalised by the whole batch's counts, so that it fits beside nothing
larger than a block's activations.

``mode`` says how the parts that the configuration runs under bf16
autocast (backbone, transformer) are computed: ``"f32"`` (the reference;
TF32 must be off), ``"bf16"`` (the configuration's own precision, the
yardstick of its round-off: operands, outputs and gradients of every
convolution and matrix product rounded to bf16) or ``"fp8"`` (the control:
operands of every convolution and matrix product scaled per tensor to
float8 e4m3, their gradients to e5m2, outputs rounded to bf16).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .params import PLANES, STAGES

BN_EPS = 1e-5
LN_EPS = 1e-6
NEG = -1.0e9
COST_CLAMP = 100.0
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def model_settings(config: Dict) -> Dict:
    """The reference's settings from a configuration file's ``model``."""
    m = dict(config["model"])
    if m["self_sup"]:
        m["num_classes"], m["dec_at"] = 1, False
    return m


# ----------------------------------------------------------------- precision


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Values forward and gradients back rounded to ``fp8`` (scaled per
    tensor) or to ``bf16``."""

    @staticmethod
    def forward(ctx, x, to):
        ctx.to = to
        return x.bfloat16().float() if to == "bf16" else _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.to == "bf16":
            return g.bfloat16().float(), None
        return _fp8(g, torch.float8_e5m2, E5M2_MAX), None


def _in(x: torch.Tensor, mode: str) -> torch.Tensor:
    return x if mode == "f32" else _Round.apply(x, mode)


def _out(x: torch.Tensor, mode: str) -> torch.Tensor:
    return x if mode == "f32" else _Round.apply(x, "bf16")


def conv(x, w, b, mode, stride=1, padding=0, dilation=1):
    b = None if b is None else _in(b, mode)
    return _out(F.conv2d(_in(x, mode), _in(w, mode), b, stride, padding, dilation), mode)


def linear(x, w, b, mode="f32"):
    return _out(F.linear(_in(x, mode), _in(w, mode), None if b is None else _in(b, mode)), mode)


def matmul(a, b, mode):
    return _out(torch.matmul(_in(a, mode), _in(b, mode)), mode)


# ------------------------------------------------------------------- forward


class Draws:
    """The step's draws from the trainer's generator, each at the whole
    batch's shape and in the program's order, kept so that each block of
    rows takes its slice of the same draws."""

    def __init__(self, gen: torch.Generator, batch: int):
        self.gen, self.batch = gen, batch
        self.kept: List[torch.Tensor] = []
        self.rows, self.i = slice(None), 0

    def block(self, rows: slice) -> "Draws":
        self.rows, self.i = rows, 0
        return self

    def mask(self, tail, device, keep) -> torch.Tensor:
        """``keep(u)`` of a uniform draw of shape [batch, *tail], this block's rows."""
        if self.i == len(self.kept):
            u = torch.rand((self.batch, *tail), generator=self.gen, device=device)
            self.kept.append(keep(u))
        self.i += 1
        return self.kept[self.i - 1][self.rows]


def dropout(x: torch.Tensor, rate: float, draws: Optional[Draws]) -> torch.Tensor:
    if draws is None or rate == 0.0:
        return x
    keep = draws.mask(x.shape[1:], x.device, lambda u: u < 1.0 - rate)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


def frozen_bn(x: torch.Tensor, P: Dict, name: str) -> torch.Tensor:
    w = P[f"{name}.scale"] / torch.sqrt(P[f"{name}.var"] + BN_EPS)
    b = P[f"{name}.bias"] - P[f"{name}.mean"] * w
    return x * w[:, None, None] + b[:, None, None]


def backbone(P: Dict, x: torch.Tensor, mode: str) -> torch.Tensor:
    """[N, T, F, 1] -> [N, T/16, F/16, 2048]."""
    x = x.permute(0, 3, 1, 2)
    x = conv(x, P["backbone.conv0.weight"], P["backbone.conv0.bias"], mode)
    x = conv(x, P["backbone.conv1.weight"], None, mode, stride=2, padding=3)
    x = F.relu(frozen_bn(x, P, "backbone.bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for li, n in enumerate(STAGES):
        for bi in range(n):
            pre = f"backbone.layer{li + 1}_{bi}"
            stride = (1, 2, 2, 1)[li] if bi == 0 else 1
            dil = 2 if (li == 3 and bi > 0) else 1
            out = F.relu(frozen_bn(conv(x, P[f"{pre}.conv1.weight"], None, mode), P, f"{pre}.bn1"))
            out = conv(out, P[f"{pre}.conv2.weight"], None, mode, stride, dil, dil)
            out = F.relu(frozen_bn(out, P, f"{pre}.bn2"))
            out = frozen_bn(conv(out, P[f"{pre}.conv3.weight"], None, mode), P, f"{pre}.bn3")
            if bi == 0:
                x = frozen_bn(conv(x, P[f"{pre}.downsample_conv.weight"], None, mode, stride),
                              P, f"{pre}.downsample_bn")
            x = F.relu(out + x)
    return x.permute(0, 2, 3, 1)


def sine_position(pad: torch.Tensor, d: int) -> torch.Tensor:
    """[B, T', F'] padding (True = padded) -> [B, T', F', d]: the count of
    unpadded frames along time, normalised to 2 pi, over 10000^(2 (i // 2)
    / d); even channels sine, odd channels cosine."""
    y = torch.cumsum((~pad).float(), dim=1)
    y = y / (y[:, -1:, :] + 1e-6) * (2 * math.pi)
    i = torch.arange(d, device=pad.device)
    dim_t = 10000.0 ** (2.0 * (i // 2).float() / d)
    p = y[..., None] / dim_t
    return torch.where(i % 2 == 0, torch.sin(p), torch.cos(p))


def layer_norm(x: torch.Tensor, P: Dict, name: str) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def attention(P, name, q_in, k_in, v_in, bias, m, draws, mode):
    b, sq, d = q_in.shape
    sk, h = k_in.shape[1], m["nheads"]
    proj = lambda x, p, s: linear(x, P[f"{name}.{p}.weight"], P[f"{name}.{p}.bias"],
                                  mode).reshape(b, s, h, d // h).transpose(1, 2)
    q, k, v = proj(q_in, "q_proj", sq), proj(k_in, "k_proj", sk), proj(v_in, "v_proj", sk)
    logits = matmul(q, k.transpose(-1, -2), mode).float() / math.sqrt(d // h)
    if bias is not None:
        logits = logits + bias
    probs = dropout(torch.softmax(logits, dim=-1), m["dropout"], draws)
    out = matmul(probs, v, mode).transpose(1, 2).reshape(b, sq, d)
    return linear(out, P[f"{name}.out_proj.weight"], P[f"{name}.out_proj.bias"], mode)


def ffn(P, name, x, m, draws, mode):
    hidden = F.relu(linear(x, P[f"{name}.linear1.weight"], P[f"{name}.linear1.bias"], mode))
    hidden = dropout(hidden, m["dropout"], draws)
    return linear(hidden, P[f"{name}.linear2.weight"], P[f"{name}.linear2.bias"], mode)


def transformer(P, src, pos, key_bias, query, self_bias, m, draws, mode):
    """Pre-norm encoder and decoder; returns every decoder layer's normed
    output [L, B, Q, D]."""
    drop = lambda x: dropout(x, m["dropout"], draws)
    for i in range(m["enc_layers"]):
        pre = f"transformer.encoder_layer_{i}"
        s2 = layer_norm(src, P, f"{pre}.norm1")
        src = src + drop(attention(P, f"{pre}.self_attn", s2 + pos, s2 + pos, s2, key_bias, m,
                                   draws, mode))
        src = src + drop(ffn(P, f"{pre}.ffn", layer_norm(src, P, f"{pre}.norm2"), m, draws, mode))
    memory = layer_norm(src, P, "transformer.encoder_norm")
    tgt = torch.zeros_like(query)
    hs = []
    for i in range(m["dec_layers"]):
        pre = f"transformer.decoder_layer_{i}"
        t2 = layer_norm(tgt, P, f"{pre}.norm1")
        tgt = tgt + drop(attention(P, f"{pre}.self_attn", t2 + query, t2 + query, t2, self_bias,
                                   m, draws, mode))
        t2 = layer_norm(tgt, P, f"{pre}.norm2")
        tgt = tgt + drop(attention(P, f"{pre}.cross_attn", t2 + query, memory + pos, memory,
                                   key_bias, m, draws, mode))
        tgt = tgt + drop(ffn(P, f"{pre}.ffn", layer_norm(tgt, P, f"{pre}.norm3"), m, draws, mode))
        hs.append(layer_norm(tgt, P, "transformer.decoder_norm"))
    return torch.stack(hs)


def mlp(P, name, x, layers):
    for i in range(layers):
        x = linear(x, P[f"{name}.layer{i}.weight"], P[f"{name}.layer{i}.bias"])
        x = F.relu(x) if i < layers - 1 else x
    return x


def encode(P, feats, queries, self_bias, m, draws, mode):
    """Backbone, positions, input projection and transformer: hs [L, B, Q, D]."""
    x = backbone(P, feats, mode)  # [B, T', F', C]
    b, tp, fp, _ = x.shape
    pad = torch.zeros((b, tp, fp), dtype=torch.bool, device=feats.device)  # clips at full length
    pos = sine_position(pad, m["hidden_dim"]).reshape(b, tp * fp, -1)
    src = conv(x.permute(0, 3, 1, 2).float(), P["input_proj.weight"], P["input_proj.bias"], "f32")
    src = src.flatten(2).transpose(1, 2)
    key_bias = torch.zeros((b, 1, 1, tp * fp), device=feats.device)
    return transformer(P, src, pos, key_bias, queries, self_bias, m, draws, mode)


def heads(P, hs, m) -> Dict[str, torch.Tensor]:
    out = {}
    if m["dec_at"]:
        out["at"] = torch.sigmoid(linear(hs[-1, :, 0], P["weak_class_embed.weight"],
                                         P["weak_class_embed.bias"]))
        hs = hs[:, :, 1:]
    out["logits"] = linear(hs, P["class_embed.weight"], P["class_embed.bias"])  # [L, B, Q, C+1]
    out["boxes"] = torch.sigmoid(mlp(P, "bbox_embed", hs, 3))
    return out


def sedt_forward(P, feats, m, draws, mode):
    b = feats.shape[0]
    queries = P["query_embed.weight"][None].expand(b, -1, -1)
    return heads(P, encode(P, feats, queries, None, m, draws, mode), m)


def crops(feats: torch.Tensor, boxes: torch.Tensor, out_t: int, out_f: int) -> torch.Tensor:
    """[B, T, F] features, [B, P, 2] (center, length) boxes -> [B, P, out_t,
    out_f, 1]: frames floor(start T) to floor(end T) (an empty crop grows by
    a frame each way), resized by bilinear interpolation with half-pixel
    centres, one crop at a time; a frame past the end repeats the last."""
    b, t, f = feats.shape
    rows = []
    cl = boxes.detach().cpu().numpy().astype(np.float32)
    for i in range(b):
        for c, length in cl[i]:
            s = int(np.floor(np.float32(c - length / np.float32(2.0)) * np.float32(t)))
            e = int(np.floor(np.float32(c + length / np.float32(2.0)) * np.float32(t)))
            if s >= e:
                s, e = max(0, s - 1), min(t, e + 1)
            idx = torch.arange(s, e, device=feats.device).clamp(0, t - 1)
            crop = feats[i, idx][None, None]  # [1, 1, e - s, F]
            rows.append(F.interpolate(crop, size=(out_t, out_f), mode="bilinear",
                                      align_corners=False)[0, 0])
    return torch.stack(rows).reshape(b, -1, out_t, out_f, 1)


def block_bias(nq: int, groups: int, device) -> torch.Tensor:
    g = torch.arange(nq, device=device) // (nq // groups)
    return torch.where(g[:, None] == g[None, :], 0.0, NEG)[None, None]


def spsedt_forward(P, feats, patches, m, draws, mode):
    b, p = patches.shape[:2]
    per = m["num_queries"] // m["num_patches"]
    pooled = backbone(P, patches.flatten(0, 1), mode).float().mean(dim=(1, 2))  # [B P, C]
    if mode != "f32":
        pooled = _out(pooled, mode)
    pq = linear(pooled, P["patch2query.weight"], P["patch2query.bias"])
    pq = pq.reshape(b, p, 1, -1).expand(-1, -1, per, -1).reshape(b, p * per, -1)
    keep = draws.mask((m["num_queries"], 1), feats.device, lambda u: u > m["mask_ratio"])
    queries = 2.0 * P["query_embed.weight"][None] + pq * keep.float()
    hs = encode(P, feats, queries, block_bias(m["num_queries"], m["num_patches"], feats.device),
                m, draws, mode)
    out = heads(P, hs, m)
    out["feature"] = mlp(P, "feature_align", hs, 2)  # [L, B, Q, C]
    out["gt_feature"] = pooled.reshape(b, p, -1)
    return out


# ----------------------------------------------------------------- criterion


class Targets(NamedTuple):
    labels: torch.Tensor  # [B, M] long
    boxes: torch.Tensor  # [B, M, 2] (center, length)
    valid: torch.Tensor  # [B, M] bool


def _se(b: torch.Tensor) -> torch.Tensor:
    return torch.stack([b[..., 0] - b[..., 1] / 2, b[..., 0] + b[..., 1] / 2], dim=-1)


def match(logits: torch.Tensor, boxes: torch.Tensor, t: Targets, loss_cfg: Dict) -> torch.Tensor:
    """Hungarian matching of every layer and clip: [L, B, Q] target per query
    (-1 unmatched), minimising class, L1 and GIoU costs over the valid
    targets (as many matches as there are queries or targets)."""
    with torch.no_grad():
        prob = torch.softmax(logits, dim=-1)  # [L, B, Q, C+1]
        q = logits.shape[2]
        cls = -prob.gather(-1, t.labels[None, :, None, :].expand(logits.shape[0], -1, q, -1))
        ps, ts = _se(boxes)[..., :, None, :], _se(t.boxes)[None, :, None, :, :]
        l1 = (ps - ts).abs().sum(-1)
        inter = (torch.minimum(ps[..., 1], ts[..., 1])
                 - torch.maximum(ps[..., 0], ts[..., 0])).clamp(min=0)
        union = (ps[..., 1] - ps[..., 0]) + (ts[..., 1] - ts[..., 0]) - inter
        hull = (torch.maximum(ps[..., 1], ts[..., 1])
                - torch.minimum(ps[..., 0], ts[..., 0])).clamp(min=0)
        giou = inter / union - (hull - union) / hull.clamp(min=1e-9)
        cost = (loss_cfg["set_cost_bbox"] * l1 + loss_cfg["set_cost_class"] * cls
                - loss_cfg["set_cost_giou"] * giou).clamp(-COST_CLAMP, COST_CLAMP)
        cost = cost.cpu().numpy()
    from scipy.optimize import linear_sum_assignment

    valid = t.valid.cpu().numpy()
    n_layers, b = cost.shape[:2]
    out = np.full((n_layers, b, q), -1, np.int64)
    for layer in range(n_layers):
        for i in range(b):
            cols = np.flatnonzero(valid[i])
            if cols.size:
                r, c = linear_sum_assignment(cost[layer, i][:, cols])
                out[layer, i, r] = cols[c]
    return torch.from_numpy(out).to(logits.device)


def normalisers(t: Targets, m: Dict) -> Tuple[float, float]:
    """The whole batch's matched count (every strong clip matches as many
    targets as it has, up to the query count) and its labeled clips."""
    n_valid = t.valid.sum(-1)
    strong = n_valid > 0
    n_boxes = torch.minimum(n_valid, torch.tensor(m["num_queries"]))[strong].sum()
    return max(float(n_boxes), 1.0), float(strong.sum())


def set_loss(out: Dict, t: Targets, loss_cfg: Dict, m: Dict, n_boxes: float,
             n_labeled: float) -> torch.Tensor:
    """The weighted set loss of every decoder layer (each matched on its
    own), SEDT's clip-tag BCE and SP-SEDT's feature reconstruction, over
    the whole batch's normalisers (:func:`normalisers`)."""
    tq = match(out["logits"], out["boxes"], t, loss_cfg)  # [L, B, Q]
    matched = tq >= 0
    strong = t.valid.any(-1)  # [B]
    c = m["num_classes"]
    safe = tq.clamp(min=0)
    cls_t = torch.where(matched, _take(t.labels, safe), c)
    w_cls = torch.where(cls_t == c, loss_cfg["eos_coef"], 1.0)
    logp = torch.log_softmax(out["logits"], dim=-1)
    ce = -logp.gather(-1, cls_t[..., None])[..., 0] * w_cls
    sw = strong[None, :, None].float()
    loss = loss_cfg["ce"] * (ce * sw).sum() / n_boxes
    pb, tb = _se(out["boxes"]), _se(_take(t.boxes, safe))
    mw = matched.float() * sw
    l1 = (pb - tb).abs().sum(-1)
    inter = (torch.minimum(pb[..., 1], tb[..., 1]) - torch.maximum(pb[..., 0], tb[..., 0])).clamp(min=0)
    union = (pb[..., 1] - pb[..., 0]) + (tb[..., 1] - tb[..., 0]) - inter
    hull = (torch.maximum(pb[..., 1], tb[..., 1]) - torch.minimum(pb[..., 0], tb[..., 0])).clamp(min=0)
    giou = inter / union.clamp(min=1e-9) - (hull - union) / hull.clamp(min=1e-9)
    loss = loss + loss_cfg["bbox"] * (l1 * mw).sum() / n_boxes
    loss = loss + loss_cfg["giou"] * ((1.0 - giou) * mw).sum() / n_boxes
    if "feature" in out:
        unit = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-12)
        tgt = _take(out["gt_feature"], safe)  # [L, B, Q, C]
        mse = ((unit(out["feature"]) - unit(tgt)) ** 2).sum(-1)
        loss = loss + loss_cfg["feature"] * (mse * mw).sum() / n_boxes
    if "at" in out:
        gt = F.one_hot(t.labels, c).float().mul(t.valid[..., None]).sum(1).clamp(0, 1)
        p = out["at"].clamp(1e-7, 1 - 1e-7)
        bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
        labeled = t.valid.any(-1).float()
        loss = loss + loss_cfg["weak"] * (bce * labeled[:, None]).sum() / max(n_labeled * c, 1.0)
    return loss


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, M, ...] at idx [L, B, Q] -> [L, B, Q, ...]."""
    n_layers = idx.shape[0]
    a = arr[None].expand(n_layers, *arr.shape)
    ix = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(idx.shape + arr.shape[2:])
    return a.gather(2, ix)


# ----------------------------------------------------------------- optimizer


def trainable(name: str, opt_cfg: Dict) -> bool:
    return not any(name.startswith(p) for p in opt_cfg["frozen"])


class AdamW:
    """Clip by global norm (scale by max / norm when norm >= max), then
    AdamW with decoupled decay, the backbone at its own learning rate."""

    def __init__(self, params: Dict[str, torch.Tensor], names: List[str], opt_cfg: Dict):
        self.cfg = opt_cfg
        self.names = [n for n in names if trainable(n, opt_cfg)]
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        c = self.cfg
        g = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
             for n in self.names}
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
        scale = torch.where(norm < c["clip_max_norm"], 1.0, c["clip_max_norm"] / norm)
        g = {n: x * scale for n, x in g.items()}
        self.t += 1
        b1, b2 = c["betas"]
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n in self.names:
            lr = c["lr_backbone"] if n.startswith("backbone.") else c["lr"]
            p = params[n]
            p.mul_(1 - lr * c["weight_decay"])
            self.m[n].mul_(b1).add_(g[n], alpha=1 - b1)
            self.v[n].mul_(b2).add_(g[n] * g[n], alpha=1 - b2)
            p.sub_(lr / bc1 * self.m[n] / (self.v[n].sqrt() / math.sqrt(bc2) + c["eps"]))
        return g


OUTPUTS = ("pred_logits", "pred_boxes", "at", "pred_feature", "gt_feature")


def outputs(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The forward's outputs under the program's names (its model's dict):
    the last decoder layer's, and the pooled patch features; on the host."""
    got = {"pred_logits": out["logits"][-1], "pred_boxes": out["boxes"][-1], "at": out.get("at"),
           "pred_feature": out["feature"][-1] if "feature" in out else None,
           "gt_feature": out.get("gt_feature")}
    return {k: v.detach().float().cpu() for k, v in got.items() if v is not None}


def train_step(params: Dict[str, torch.Tensor], opt: AdamW, feats: torch.Tensor, t: Targets,
               config: Dict, gen: torch.Generator, mode: str = "f32",
               patch_boxes: Optional[torch.Tensor] = None, block: int = 64,
               keep: Optional[List[Dict[str, torch.Tensor]]] = None):
    """One training step from ``params`` (updated in place), its gradients
    summed over blocks of ``block`` rows; returns (loss, the clipped
    gradients).  With ``keep``, each block's :func:`outputs` are appended
    to it."""
    m = model_settings(config)
    names = opt.names
    leaves = {n: (params[n].detach().requires_grad_(True) if n in names else params[n])
              for n in params}
    n_boxes, n_labeled = normalisers(t, m)
    draws = Draws(gen, feats.shape[0])
    total, grads = torch.zeros((), device=feats.device), None
    for lo in range(0, feats.shape[0], block):
        rows = slice(lo, lo + block)
        tb = Targets(*(x[rows] for x in t))
        if m["self_sup"]:
            patches = crops(feats[rows], patch_boxes[rows], *m["patch"])
            out = spsedt_forward(leaves, feats[rows, ..., None], patches, m, draws.block(rows), mode)
        else:
            out = sedt_forward(leaves, feats[rows, ..., None], m, draws.block(rows), mode)
        if keep is not None:
            keep.append(outputs(out))
        loss = set_loss(out, tb, config["loss"], m, n_boxes, n_labeled)
        got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = got if grads is None else [g if a is None else (a if g is None else a + g)
                                           for a, g in zip(grads, got)]
        total = total + loss.detach()
        del out, loss, got
    clipped = opt.step(params, dict(zip(names, grads)))
    return total, clipped
