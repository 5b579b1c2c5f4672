"""The two collectives of a tensor-parallel region over the model group.

Counterpart of what GSPMD inserts around the JAX package's column- and
row-split projections (``parallel/mesh.py``'s ``_TP_RULES``), in the
Megatron form:

* :func:`copy_to_model` on the input of a column-split projection (q/k/v,
  the FFN's first linear): the identity forward; backward, the ``all_reduce``
  over the model group of the input's gradient, each rank having computed
  the part that flows through its heads or hidden units;
* :func:`reduce_from_model` on the output of a row-split projection
  (``out_proj``, the FFN's second linear), before its bias: the
  ``all_reduce`` of the ranks' partial products forward, in the partial's
  type (the caller adds the bias once); the identity backward, the output's
  gradient being replicated.

Both are the identity with one rank on the model axis.  ``all_reduce`` is
the only collective, which both NCCL and gloo run on CUDA tensors.
``timer``, when set, wraps every call (the chip check times the collectives
with it).  :func:`same_bits_on_every_rank` keeps the replicated layers,
which every rank of a model group computes side by side, bit for bit equal.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

from .distribute import model_group, model_world

timer: Optional[Callable] = None  # a context-manager factory: with timer(): around each call


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x``, summed over the model group."""
    out = x.clone(memory_format=torch.contiguous_format)
    with timer() if timer is not None else contextlib.nullcontext():
        dist.all_reduce(out, group=model_group())
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group."""
    return x if model_world() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group; its gradient passed through."""
    return x if model_world() == 1 else _ReduceFromModel.apply(x)


@contextlib.contextmanager
def same_bits_on_every_rank() -> Iterator[None]:
    """cuDNN's deterministic algorithms while several model ranks compute
    the replicated layers (the backbone, the norms, the heads) side by side:
    each rank must get the same bits, or the replicated parameters drift
    apart over the model group.  A no-op at one model rank."""
    if model_world() == 1:
        yield
        return
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
