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

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout of ``x``; the identity when ``deterministic`` or at
    rate 0.  Raises without a generator otherwise, as flax does without a
    ``"dropout"`` stream."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator when deterministic is False")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    # at rate 1 nothing is kept; scaling by 0 keeps the gradient finite there
    scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))
