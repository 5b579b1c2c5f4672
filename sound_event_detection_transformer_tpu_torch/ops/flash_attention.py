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
* The gradient.  A forward that will be differentiated keeps each row's
  statistics (``stats``, f32 ``[B, H, Sq, 2]``: the maximum ``m`` of the
  row's scaled and biased scores and ``l``, the sum of ``exp(s - m)``), and
  the backward recomputes the probabilities block by block from them, as
  FlashAttention 2 does, never writing an ``[Sq, Sk]`` tensor.  On CUDA
  tensors that took the tensor-core variant, with no bias or one that needs
  no gradient, it launches the backward kernels of ``csrc/flash_attention.cu``
  (:func:`flash_attention_backward`; each call counts into
  ``flash_attention.backward_launches``).  On CPU tensors it runs
  :func:`flash_attention_backward_plain`, the same arithmetic in PyTorch.
  What is left, the f32-core variant and, on either device, a bias that
  needs a gradient, recomputes :func:`reference_attention` and
  differentiates that, as the JAX package does, counted in
  ``flash_attention.recomputes``.  Every backward runs in the
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
ROW_PAD = 128  # the backward's row constants are padded to a multiple of this (kRowPad)
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
                          block_k: int = BLOCK_K, with_stats: bool = False):
    """The plain PyTorch version of K4, on any device: a loop over key blocks
    with the running (max, sum, accumulator) in f32.  ``with_stats`` returns
    ``(out, stats)``, stats the f32 ``[B, H, Sq, 2]`` of each row's maximum
    ``m`` and sum ``l`` of ``exp(s - m)`` (``m + log l`` is the row's
    log-sum-exp)."""
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
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return (out, torch.cat([m, l], dim=-1)) if with_stats else out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   bias: Optional[torch.Tensor], out: torch.Tensor,
                                   stats: torch.Tensor, grad_out: torch.Tensor):
    """The plain PyTorch version of K4's backward, on any device: the
    probabilities recomputed key block by key block from the forward's
    ``stats`` (``p = exp(s - m) / l``, ``s`` scored as
    :func:`flash_attention_plain` scores it), ``D = rowsum(grad_out * out)``,
    ``dS = p (dP - D)``, everything in f32.  Returns ``(dq, dk, dv)`` in the
    inputs' type; the bias gets no gradient."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    g = grad_out.float()
    if bias is not None:
        full_bias = bias.float().expand(b, h, sq, sk)
    m, l = stats[..., :1], stats[..., 1:].clamp_min(1e-30)
    delta = (g * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, BLOCK_K):
        sl = slice(k0, k0 + BLOCK_K)
        kb, vb = k[:, :, sl].float(), v[:, :, sl].float()
        s = torch.matmul(qf, kb.transpose(-1, -2))
        if bias is not None:
            s = s + full_bias[..., sl]
        p = torch.exp(s - m) / l
        dv[:, :, sl] = torch.matmul(p.transpose(-1, -2), g)
        ds = p * (torch.matmul(g, vb.transpose(-1, -2)) - delta)
        dq += torch.matmul(ds, kb)
        dk[:, :, sl] = torch.matmul(ds.transpose(-1, -2), qf)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.sedt_flash_attention_mma.restype = ctypes.c_int
    lib.sedt_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.sedt_flash_attention_bwd.restype = ctypes.c_int
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


def _bias_args(bias, shape):
    """The bias's pointer, its four broadcast strides, and whether a full bias
    may be read two floats at a time (key stride 1, the others even, an
    8-byte-aligned address)."""
    if bias is None:
        return None, [0] * 4, False
    strides = list(bias.expand(shape).stride())
    vec2 = (strides[3] == 1 and bias.data_ptr() % 8 == 0 and not any(x % 2 for x in strides[:3]))
    return bias.data_ptr(), strides, vec2


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _launch(q, k, v, bias, with_stats: bool = False):
    """Launch the kernel :func:`kernel_variant` names; returns the output and
    what the backward kernels keep of the forward: where ``with_stats`` and
    the tensor-core variant ran, the rows' f32 ``[B, H, Sq, 2]`` (m, l) and
    ``out_lo``, what rounding the f32 output to the output's type lost, else
    two Nones."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    variant = kernel_variant(q.dtype, d, [(t.stride(), t.data_ptr()) for t in (q, k, v)])
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    stats = out_lo = None
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]]
    bias_ptr, bias_strides, vec2 = _bias_args(bias, (b, h, sq, sk))
    strides = (ctypes.c_longlong * 16)(*strides, *bias_strides)
    index = _device_index(q)
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
            if with_stats:
                stats = torch.empty((b, h, sq, 2), dtype=torch.float32, device=q.device)
                out_lo = torch.empty_like(out)
            err = lib.sedt_flash_attention_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if stats is None else stats.data_ptr(),
                None if out_lo is None else out_lo.data_ptr(), b, h, sq, sk, d, rows,
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
    return out, stats, out_lo


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the backward kernels can read its rows in 16-byte
    copies (dense last dim, other strides multiples of 8, a 16-byte-aligned
    address), else a contiguous copy."""
    if t.stride(3) == 1 and not any(x % 8 for x in t.stride()[:3]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: Optional[torch.Tensor], out: torch.Tensor,
                             stats: torch.Tensor, grad_out: torch.Tensor,
                             out_lo: torch.Tensor):
    """``(dq, dk, dv)`` of the tensor-core variant's forward on CUDA tensors
    through the backward kernels (no gradient for the bias): ``out``,
    ``stats`` and ``out_lo`` are what that forward returned (:func:`_launch`
    with ``with_stats``), ``grad_out`` the output's gradient.  Each row's
    ``D = rowsum(grad_out * (out + out_lo))``: from ``out`` alone, as
    FlashAttention 2 takes it, D would carry the output's bf16 rounding and a
    row's score gradients would no longer sum to 0.  Raises for inputs the
    tensor-core variant does not take."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if kernel_variant(q.dtype, d, [(t.stride(), t.data_ptr()) for t in (q, k, v)]) != "tensor":
        raise ValueError("the backward kernels take the tensor-core variant's inputs only")
    if stats.shape != (b, h, sq, 2) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous f32 [B, H, Sq, 2], got {tuple(stats.shape)}")
    for name, t in (("out", out), ("out_lo", out_lo)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and shaped and typed as q")
    grad_out = _aligned_rows(grad_out.to(q.dtype))
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    sq_pad = -(-sq // ROW_PAD) * ROW_PAD
    rowc = torch.empty(b * h * sq_pad * 4, dtype=torch.float32, device=q.device)
    bias_ptr, bias_strides, vec2 = _bias_args(bias, (b, h, sq, sk))
    strides = [x for t in (q, k, v, out, grad_out, dq, dk, dv) for x in t.stride()[:3]]
    strides = (ctypes.c_longlong * 28)(*strides, *bias_strides)
    index = _device_index(q)
    lib, _ = _device(index)
    with torch.cuda.device(index):
        err = lib.sedt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
            out_lo.data_ptr(), grad_out.data_ptr(),
            stats.data_ptr(), rowc.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, sq_pad, int(vec2), strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel K4's backward launch failed: cudaError {err}")
    flash_attention.backward_launches += 1
    return dq, dk, dv


def _forward(q, k, v, bias, with_stats: bool):
    """The output and what the blockwise backward keeps besides the inputs:
    the output, its row statistics and, from the kernel, ``out_lo``; or
    nothing, where the backward will recompute."""
    _check_inputs(q, k, v, bias)
    # a bias that needs a gradient takes the recompute, which needs no stats
    with_stats = with_stats and not (bias is not None and bias.requires_grad)
    if q.device.type == "cpu":
        if with_stats:
            out, stats = flash_attention_plain(q, k, v, bias, with_stats=True)
            return out, (out, stats)
        return flash_attention_plain(q, k, v, bias), ()
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out, stats, out_lo = _launch(q, k, v, bias, with_stats)
    return out, (() if stats is None else (out, stats, out_lo))


def _recompute(q, k, v, bias, wants_bias: bool, grad_out):
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        bd = bias.detach().requires_grad_() if wants_bias else bias
        out = reference_attention(qd, kd, vd, bd)
    grads = torch.autograd.grad(out, [qd, kd, vd] + ([bd] if wants_bias else []), grad_out)
    flash_attention.recomputes += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, with_stats):
        out, kept = _forward(q, k, v, bias, with_stats)
        ctx.save_for_backward(q, k, v, bias, *kept)  # no [Sq, Sk] tensor
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias, *kept = ctx.saved_tensors
        wants_bias = bias is not None and ctx.needs_input_grad[3]
        with annotate("attention.backward", any_thread=True):
            if not kept:
                grads = _recompute(q, k, v, bias, wants_bias, grad_out)
            elif q.device.type == "cpu":
                grads = flash_attention_backward_plain(q, k, v, bias, *kept, grad_out)
            else:
                out, stats, out_lo = kept
                grads = flash_attention_backward(q, k, v, bias, out, stats, grad_out, out_lo)
        return (*grads, None) if wants_bias else (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, Sq, D] attention through kernel K4 (its plain version on the
    CPU); differentiable with respect to q, k, v and the bias."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    return _FlashAttention.apply(q, k, v, bias, grad)


flash_attention.launches = 0  # every forward kernel launch, whichever variant
flash_attention.launches_tensor = 0  # of those, the tensor-core variant's
flash_attention.launches_f32 = 0  # and the f32-core variant's
flash_attention.launches_split = 0  # tensor-core launches that split the keys
flash_attention.backward_launches = 0  # backward calls through the backward kernels
flash_attention.recomputes = 0  # backward calls that recomputed the plain attention
