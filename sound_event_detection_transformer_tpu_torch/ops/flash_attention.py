"""Kernel K4: attention forward by blocks with an online softmax.

``flash_attention(q, k, v, bias)`` is the counterpart of the JAX package's
``ops/pallas/flash_attention.flash_attention`` (kernel ``_flash_kernel``):
q ``[B, H, Sq, D]``, k and v ``[B, H, Sk, D]`` in bf16 or f32, an additive f32
bias broadcastable to ``[B, H, Sq, Sk]`` or None; q, k and v are upcast to
f32, the running maximum, sum and accumulator are f32, and the output comes
back in the input type.  The ``[Sq, Sk]`` scores are never written out.

* On CUDA tensors it launches the hand-written kernel of
  ``csrc/flash_attention.cu`` (built with nvcc on first use) or raises, and
  counts the launch in ``flash_attention.launches``.  The kernel takes head
  dims 16, 32, 64 and 128, reads q, k and v through their strides (only the
  last dim must be dense) and the bias through its broadcast strides.
* On CPU tensors it runs :func:`flash_attention_plain`, the same blockwise
  arithmetic in PyTorch.
* The gradient, as in the JAX package, has no kernel: the backward recomputes
  :func:`reference_attention`, the plain non-flash math, and differentiates
  that, so training through the kernel gets the non-flash path's gradients.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._build import load_library

NEG_INF = -1.0e30  # start of the running maximum: finite, so no inf - inf
BLOCK_K = 128  # key block of the plain version
HEAD_DIMS = (16, 32, 64, 128)  # what the kernel is compiled for
_VEC = 4  # elements per vector load in the kernel


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The non-flash attention math: f32 logits and softmax, probabilities
    rounded to v's type before the second product."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """The plain PyTorch version of K4, on any device: a loop over key blocks
    with the running (max, sum, accumulator) in f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf = q.float() * (1.0 / math.sqrt(d))
    if bias is not None:
        bias = bias.float().expand(b, h, sq, sk)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        s = torch.matmul(qf, kb.transpose(-1, -2))
        if bias is not None:
            s = s + bias[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    lib.sedt_flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.sedt_flash_attention.restype = ctypes.c_int
    return lib


def _check_inputs(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if sq < 1 or sk < 1:
        raise ValueError("empty sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if bias.device != q.device:
            raise ValueError("bias must lie on the device of q")
        bias.expand(b, h, sq, sk)  # raises unless broadcastable


def _launch(q, k, v, bias) -> torch.Tensor:
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel K4 takes head dims {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(s % _VEC for s in t.stride()[:3])
                or t.data_ptr() % (_VEC * t.element_size())):
            raise ValueError(f"{name}: the last dim must be dense and the other strides and "
                             f"the address multiples of {_VEC} elements, got strides "
                             f"{t.stride()}")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    strides += [0] * 4 if bias is None else list(bias.expand(b, h, sq, sk).stride())
    with torch.cuda.device(q.device):
        err = _library().sedt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, sq, sk, d,
            (ctypes.c_longlong * 16)(*strides),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel K4 launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


def _forward(q, k, v, bias) -> torch.Tensor:
    _check_inputs(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, bias)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)  # the inputs only, no [Sq, Sk] tensor
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        wants_bias = bias is not None and ctx.needs_input_grad[3]
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            bd = bias.detach().requires_grad_() if wants_bias else bias
            out = reference_attention(qd, kd, vd, bd)
        grads = torch.autograd.grad(out, [qd, kd, vd] + ([bd] if wants_bias else []), grad_out)
        return (*grads, None) if not wants_bias else grads


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, Sq, D] attention through kernel K4 (its plain version on the
    CPU); differentiable with respect to q, k, v and the bias."""
    return _FlashAttention.apply(q, k, v, bias)


flash_attention.launches = 0
