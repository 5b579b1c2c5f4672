"""Plain PyTorch AST training steps: the yardstick that decides ``correct`` in
the audio-tag cell.

Written from the paper (Gong, Chung and Glass, "AST: Audio Spectrogram
Transformer", Interspeech 2021) and the upstream code's model and recipe
(``src/models/ast_models.py``, ``src/traintest.py``) as the configuration
file states them, with plain ``torch`` operations and nothing of the program
under test: the overlapping 16 x 16 patch convolution over ``[B, 1, F, T]``,
frequency-major tokens behind the class and distillation tokens, the learned
positions, pre-norm blocks with the explicit ``softmax(q k^T / sqrt(d_h)) v``
and an erf GELU MLP, the final norm, the mean of the two leading tokens, the
head's LayerNorm (PyTorch's default eps 1e-5, as upstream builds it) and
linear layer; the mean binary cross-entropy on the logits over B x C; and
``torch.optim.Adam``'s update with its L2 weight decay added to the
gradient, no clip, at the recipe's lr of the first epoch.

A step runs in blocks of rows, each block's share of the mean BCE
(its sum over B x C) differentiated and the gradients summed, so that no
more than a block's ``[H, N, N]`` scores are alive at once.  ``mode`` is the
reference's (f32, TF32 off), the configuration's own bf16 or the float8
control, as :mod:`.model` rounds them: operands of every convolution and
matrix product, their outputs and their gradients.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .model import conv, linear, matmul
from .params import Leaf, _conv, _linear, _norm, make_weights

HEAD_EPS = 1e-5  # the head's nn.LayerNorm(768), PyTorch's default
TOKEN_RANGE = 0.02 * math.sqrt(3.0)  # uniform of std 0.02, DeiT's init scale


def settings(config: Dict) -> Dict:
    """The reference's settings: the configuration file's ``model``."""
    return dict(config["model"])


def grid(m: Dict):
    return ((m["n_mels"] - m["patch"]) // m["fstride"] + 1,
            (m["frames"] - m["patch"]) // m["tstride"] + 1)


def tokens(m: Dict) -> int:
    f, t = grid(m)
    return f * t + 2


def param_spec(m: Dict) -> List[Leaf]:
    """Every parameter under the upstream model's names."""
    d, p = m["dim"], m["patch"]
    out = _conv("v.patch_embed.proj", d, 1, p, bias=True)
    r = TOKEN_RANGE
    out += [Leaf("v.cls_token", (1, 1, d), -r, r), Leaf("v.dist_token", (1, 1, d), -r, r),
            Leaf("v.pos_embed", (1, tokens(m), d), -r, r)]
    for i in range(m["layers"]):
        pre = f"v.blocks.{i}"
        out += _norm(f"{pre}.norm1", d) + _linear(f"{pre}.attn.qkv", 3 * d, d)
        out += _linear(f"{pre}.attn.proj", d, d) + _norm(f"{pre}.norm2", d)
        out += _linear(f"{pre}.mlp.fc1", m["mlp"], d) + _linear(f"{pre}.mlp.fc2", d, m["mlp"])
    out += _norm("v.norm", d) + _norm("mlp_head.0", d) + _linear("mlp_head.1", m["num_classes"], d)
    return out


def layer_norm(x: torch.Tensor, P: Dict, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps)


def attention(P: Dict, name: str, x: torch.Tensor, m: Dict, mode: str) -> torch.Tensor:
    b, n, d = x.shape
    h = m["heads"]
    qkv = linear(x, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"], mode)
    q, k, v = qkv.reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
    logits = matmul(q, k.transpose(-1, -2), mode) / math.sqrt(d // h)
    out = matmul(torch.softmax(logits, dim=-1), v, mode).transpose(1, 2).reshape(b, n, d)
    return linear(out, P[f"{name}.proj.weight"], P[f"{name}.proj.bias"], mode)


def forward(P: Dict, x: torch.Tensor, m: Dict, mode: str = "f32") -> torch.Tensor:
    """[B, T, F] -> [B, C] logits, in the type of ``x`` and ``P``."""
    eps = m["eps"]
    x = conv(x.unsqueeze(1).transpose(2, 3), P["v.patch_embed.proj.weight"],
             P["v.patch_embed.proj.bias"], mode, stride=(m["fstride"], m["tstride"]))
    x = x.flatten(2).transpose(1, 2)  # [B, F' T', d], frequency outer
    b = x.shape[0]
    x = torch.cat([P["v.cls_token"].expand(b, -1, -1), P["v.dist_token"].expand(b, -1, -1), x],
                  dim=1) + P["v.pos_embed"]
    for i in range(m["layers"]):
        pre = f"v.blocks.{i}"
        x = x + attention(P, f"{pre}.attn", layer_norm(x, P, f"{pre}.norm1", eps), m, mode)
        hidden = linear(layer_norm(x, P, f"{pre}.norm2", eps), P[f"{pre}.mlp.fc1.weight"],
                        P[f"{pre}.mlp.fc1.bias"], mode)
        x = x + linear(F.gelu(hidden), P[f"{pre}.mlp.fc2.weight"], P[f"{pre}.mlp.fc2.bias"], mode)
    x = layer_norm(x, P, "v.norm", eps)
    pooled = layer_norm((x[:, 0] + x[:, 1]) / 2, P, "mlp_head.0", HEAD_EPS)
    return linear(pooled, P["mlp_head.1.weight"], P["mlp_head.1.bias"], mode)


class Adam:
    """``torch.optim.Adam``'s update with L2 weight decay (added to the
    gradient before the moments), over every leaf, no clip."""

    def __init__(self, params: Dict[str, torch.Tensor], opt_cfg: Dict):
        self.cfg = opt_cfg
        self.names = list(params)
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict:
        """Updates ``params`` in place; returns each leaf's gradient with the
        decay added, as the moments see it."""
        c = self.cfg
        self.t += 1
        b1, b2 = c["betas"]
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        seen = {}
        for n in self.names:
            p = params[n]
            g = (grads[n] if grads.get(n) is not None else torch.zeros_like(p))
            g = g + c["weight_decay"] * p
            seen[n] = g
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).add_(g * g, alpha=1 - b2)
            p.sub_(c["lr"] / bc1 * self.m[n] / (self.v[n].sqrt() / math.sqrt(bc2) + c["eps"]))
        return seen


def train_step(params: Dict[str, torch.Tensor], opt: Adam, x: torch.Tensor, y: torch.Tensor,
               config: Dict, mode: str = "f32", block: int = 8, keep: List = None):
    """One step from ``params`` (updated in place) on features ``x`` [B, T, F]
    and multi-hot labels ``y`` [B, C]: (the mean BCE, each leaf's gradient
    as Adam saw it).  With ``keep``, each block's logits are appended."""
    m = settings(config)
    leaves = {n: params[n].detach().requires_grad_(True) for n in opt.names}
    count = y.numel()
    total, grads = torch.zeros((), device=x.device), None
    for lo in range(0, x.shape[0], block):
        logits = forward(leaves, x[lo:lo + block], m, mode)
        if keep is not None:
            keep.append(logits.detach().cpu())
        loss = F.binary_cross_entropy_with_logits(logits, y[lo:lo + block], reduction="sum") / count
        got = torch.autograd.grad(loss, [leaves[n] for n in opt.names])
        grads = list(got) if grads is None else [a + g for a, g in zip(grads, got)]
        total = total + loss.detach()
        del logits, loss, got
    return total, opt.step(params, dict(zip(opt.names, grads)))


def readings(config: Dict, clips, rows: List[List[int]], seed_weights: int,
             device: torch.device, mode: str = "f32") -> Dict:
    """The check steps on ``rows`` of ``clips`` (features and labels on the
    host) from the seeded weights: each step's loss, the first step's logits,
    each leaf's first gradient norm and its change after the last step."""
    from .check import tf32_off

    with tf32_off():
        m = settings(config)
        spec = param_spec(m)
        params = make_weights(spec, seed_weights, device)
        opt = Adam(params, config["optimizer"])
        losses, grad, kept = [], {}, []
        for k, r in enumerate(rows):
            x = torch.as_tensor(clips.feats[r], device=device)
            y = torch.as_tensor(clips.labels[r], device=device)
            loss, g = train_step(params, opt, x, y, config, mode, keep=kept if k == 0 else None)
            losses.append(float(loss))
            if k == 0:
                grad = {n: float(torch.linalg.vector_norm(v)) for n, v in g.items()}
            del x, y, g
        w0 = make_weights(spec, seed_weights, device)
        change = {n: float(torch.linalg.vector_norm(params[n] - w0[n])) for n in opt.names}
    return {"losses": losses, "grad": grad, "change": change,
            "outputs": {"logits": torch.cat(kept)}}
