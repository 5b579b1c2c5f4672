"""Inverted dropout drawn from an explicit generator.

Counterpart of the JAX package's ``ops/dropout.py``: keep each element with
probability 1 - rate, scale the kept ones by 1 / (1 - rate), zero the rest.
The keep mask comes from a ``torch.Generator`` on the tensor's device, so a
seed fixes it; ``torch.nn.functional.dropout`` takes no generator and is not
used.

The JAX package names its keep masks (``DROPOUT_MASK``,
``remat_dropout_policy``) so that ``jax.checkpoint`` can regenerate them in
the backward pass instead of saving them.  Autograd has no such construct:
the mask is saved for the backward like any other residual (one byte an
element), and nothing here names it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool, shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout of ``x``; the identity when ``deterministic`` or at
    rate 0.  Raises without a generator otherwise, as flax does without a
    ``"dropout"`` stream.

    ``shard`` ``(dim, index, parts)``: ``x`` is slice ``index`` of ``parts``
    equal slices along ``dim`` of a whole tensor (a tensor-parallel rank's
    heads or hidden units).  The keep mask is drawn at the whole tensor's
    shape and sliced, so ranks whose generators run in lockstep tile one
    mask, the one a single rank draws for the whole tensor."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator when deterministic is False")
    shape = list(x.shape)
    if shard is not None:
        dim, index, parts = shard
        shape[dim] *= parts
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    if shard is not None:
        keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
    # at rate 1 nothing is kept; scaling by 0 keeps the gradient finite there
    scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))
