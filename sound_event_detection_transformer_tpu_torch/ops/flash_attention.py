"""Kernel K4: attention forward by blocks with an online softmax.

``flash_attention(q, k, v, bias)`` is the counterpart of the JAX package's
``ops/pallas/flash_attention.flash_attention`` (kernel ``_flash_kernel``):
q ``[B, H, Sq, D]``, k and v ``[B, H, Sk, D]`` in bf16 or f32, an additive f32
bias broadcastable to ``[B, H, Sq, Sk]`` or None; q, k and v are upcast to
f32, the running maximum, sum and accumulator are f32, and the output comes
back in the input type.  The ``[Sq, Sk]`` scores are never written out.

* On CUDA tensors it launches one of the two hand-written kernels of
  ``csrc/flash_attention.cu`` (built with nvcc on first use) or raises.
  :func:`kernel_variant` chooses from the type, the head dim, the strides and
  the addresses alone: ``"tensor"``, the tensor-core kernel (bf16 inputs,
  head dims 32, 64 and 128, q, k and v on 16-byte boundaries), which cuts the
  keys into :func:`key_splits` ranges over blocks when the query side is too
  short to fill the card and merges the ranges' partial results with a second
  small kernel; or ``"f32"``, the f32-core kernel (f32 inputs, head dim 16,
  bf16 inputs on 8-byte boundaries only).  Every call counts into
  ``flash_attention.launches`` and into ``launches_tensor`` or
  ``launches_f32``; ``launches_split`` counts the calls that split the keys.
  Both kernels read q, k and v through their strides (only the last dim must
  be dense) and the bias through its broadcast strides.
* On CPU tensors it runs :func:`flash_attention_plain`, the same blockwise
  arithmetic in PyTorch.
* The gradient, as in the JAX package, has no kernel: the backward recomputes
  :func:`reference_attention`, the plain non-flash math, and differentiates
  that, so training through the kernel gets the non-flash path's gradients.
  Each backward counts into ``flash_attention.recomputes`` and runs in the
  span ``attention.backward``, a range on autograd's thread too.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.profiler import annotate
from ._build import load_library

NEG_INF = -1.0e30  # start of the running maximum: finite, so no inf - inf
BLOCK_K = 128  # key block of the plain version
HEAD_DIMS = (16, 32, 64, 128)  # what the f32-core kernel is compiled for
TENSOR_HEAD_DIMS = (32, 64, 128)  # what the tensor-core kernel is compiled for
TILE_K = 64  # keys per staged tile of the tensor-core kernel
SPLIT_WAVES = 2  # a split aims at this many blocks per SM
_VEC = 4  # elements per vector load in the f32-core kernel
_VEC_TENSOR = 8  # bf16 per 16-byte asynchronous copy in the tensor-core kernel


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


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: Optional[torch.Tensor]):
    """``(m, l, acc)`` of one range of keys, as a block of the tensor-core
    kernel leaves them when the keys are split: the row maximum of the f32
    scores ``[B, H, Sq, 1]``, the sum of ``exp(s - m)`` and the unnormalised
    ``exp(s - m) v`` in f32.  ``bias`` is the range's own slice."""
    s = torch.matmul(q.float() * (1.0 / math.sqrt(q.shape[-1])), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias
    m = torch.maximum(s.amax(dim=-1, keepdim=True), torch.full_like(s[..., :1], NEG_INF))
    p = torch.exp(s - m)
    return m, p.sum(dim=-1, keepdim=True), torch.matmul(p, v.float())


def merge_partials(parts) -> torch.Tensor:
    """The plain version of the combine kernel: merges per-range
    ``(m, l, acc)`` triples by the online-softmax rule, ``w_i = exp(m_i - m)``
    with ``m = max m_i``, all finite, so a range whose keys are all masked
    (m about -1e9) weighs nothing beside a live one and equal ranges weigh
    alike.  Returns the f32 attention output."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = sum(torch.exp(mi - m) * li for mi, li, _ in parts)
    acc = sum(torch.exp(mi - m) * ai for mi, _, ai in parts)
    return acc / l.clamp_min(1e-30)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: Optional[torch.Tensor], keys_per_split: int) -> torch.Tensor:
    """The key split's arithmetic in plain PyTorch, on any device: every range
    of ``keys_per_split`` keys gives its partials, :func:`merge_partials`
    merges them."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    if bias is not None:
        bias = bias.float().expand(b, h, sq, sk)
    parts = []
    for k0 in range(0, sk, keys_per_split):
        sl = slice(k0, k0 + keys_per_split)
        parts.append(attention_partials(q, k[:, :, sl], v[:, :, sl],
                                        None if bias is None else bias[..., sl]))
    return merge_partials(parts).to(q.dtype)


def split_hi_lo(p: torch.Tensor):
    """f32 probabilities as two bf16 operands, ``hi = bf16(p)`` and
    ``lo = bf16(p - hi)``: the tensor-core kernel multiplies both with V into
    one f32 accumulator, which keeps 16 bits of every probability where a
    single rounding keeps 8."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def kernel_variant(dtype: torch.dtype, d: int, layouts) -> str:
    """Which kernel takes these inputs: ``"tensor"`` or ``"f32"``.  A pure
    function of the type, the head dim and, for q, k and v in turn, the
    ``(strides, address)`` pairs of ``layouts``.  Raises for what neither
    kernel takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel K4 takes head dims {HEAD_DIMS}, got {d}")
    item = 2 if dtype == torch.bfloat16 else 4

    def aligned(vec: int) -> bool:
        return all(not any(s % vec for s in strides[:3]) and address % (vec * item) == 0
                   for strides, address in layouts)

    for name, (strides, _) in zip("qkv", layouts):
        if strides[3] != 1:
            raise ValueError(f"{name}: the last dim must be dense, got strides {tuple(strides)}")
    if dtype == torch.bfloat16 and d in TENSOR_HEAD_DIMS and aligned(_VEC_TENSOR):
        return "tensor"
    if not aligned(_VEC):
        raise ValueError(f"q, k, v: the strides of the first three dims and the addresses must "
                         f"be multiples of {_VEC} elements, got "
                         f"{[tuple(s) for s, _ in layouts]}")
    return "f32"


def rows_per_block(sq: int) -> int:
    """Query rows a block of the tensor-core kernel takes: 64 for short query
    sides (4 warps of 16 rows), 128 beyond (each warp two groups of 16 rows,
    or 8 warps at head dim 128)."""
    return 64 if sq <= 64 else 128


def key_splits(blocks: int, sk: int, sms: int):
    """``(n_splits, keys_per_split)`` of the tensor-core kernel for ``blocks``
    = B * H * query tiles unsplit blocks on a card of ``sms`` SMs.  One range
    when the unsplit grid already gives every SM a block; else enough ranges
    of whole tiles for about ``SPLIT_WAVES`` blocks per SM, none empty."""
    tiles = -(-sk // TILE_K)
    if blocks >= sms or tiles == 1:
        return 1, tiles * TILE_K
    want = min(tiles, -(-SPLIT_WAVES * sms // blocks))
    tiles_per_split = -(-tiles // want)
    return -(-tiles // tiles_per_split), tiles_per_split * TILE_K


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    lib.sedt_flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.sedt_flash_attention.restype = ctypes.c_int
    lib.sedt_flash_attention_mma.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.sedt_flash_attention_mma.restype = ctypes.c_int
    lib.sedt_flash_init.argtypes = []
    lib.sedt_flash_init.restype = ctypes.c_int
    return lib


@functools.cache
def _device(index: int):
    """The library made ready on device ``index`` (the tensor-core kernels'
    shared-memory limits are raised once, not per call) and its SM count."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.sedt_flash_init()
    if err != 0:
        raise RuntimeError(f"kernel K4 init failed: cudaError {err}")
    return lib, torch.cuda.get_device_properties(index).multi_processor_count


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
    """Launch the kernel :func:`kernel_variant` names."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    variant = kernel_variant(q.dtype, d, [(t.stride(), t.data_ptr()) for t in (q, k, v)])
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    bias_strides = [0] * 4 if bias is None else list(bias.expand(b, h, sq, sk).stride())
    strides = (ctypes.c_longlong * 16)(*strides, *bias_strides)
    bias_ptr = None if bias is None else bias.data_ptr()
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    lib, sms = _device(index)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "tensor":
            rows = rows_per_block(sq)
            blocks = b * h * -(-sq // rows)
            n_splits, keys_per_split = key_splits(blocks, sk, sms)
            partial = None
            if n_splits > 1:
                partial = torch.empty(blocks * n_splits * rows * (d + 2), dtype=torch.float32,
                                      device=q.device)
            vec2 = (bias is not None and bias_strides[3] == 1 and bias.data_ptr() % 8 == 0
                    and not any(s % 2 for s in bias_strides[:3]))
            err = lib.sedt_flash_attention_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                None if partial is None else partial.data_ptr(), b, h, sq, sk, d, rows,
                n_splits, keys_per_split, int(vec2), strides, stream)
        else:
            err = lib.sedt_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                int(q.dtype == torch.bfloat16), b, h, sq, sk, d, strides, stream)
    if err != 0:
        raise RuntimeError(f"kernel K4 ({variant} variant) launch failed: cudaError {err}")
    flash_attention.launches += 1
    if variant == "tensor":
        flash_attention.launches_tensor += 1
        flash_attention.launches_split += n_splits > 1
    else:
        flash_attention.launches_f32 += 1
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
        flash_attention.recomputes += 1
        with annotate("attention.backward", any_thread=True):
            with torch.enable_grad():
                qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
                bd = bias.detach().requires_grad_() if wants_bias else bias
                out = reference_attention(qd, kd, vd, bd)
            grads = torch.autograd.grad(out, [qd, kd, vd] + ([bd] if wants_bias else []),
                                        grad_out)
        return (*grads, None) if not wants_bias else grads


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, Sq, D] attention through kernel K4 (its plain version on the
    CPU); differentiable with respect to q, k, v and the bias."""
    return _FlashAttention.apply(q, k, v, bias)


flash_attention.launches = 0  # every kernel launch, whichever variant
flash_attention.launches_tensor = 0  # of those, the tensor-core variant's
flash_attention.launches_f32 = 0  # and the f32-core variant's
flash_attention.launches_split = 0  # tensor-core launches that split the keys
flash_attention.recomputes = 0  # backward calls, each a recompute of the plain attention
