"""Rank helpers and the loss reduction for logging, for one process.

Counterpart of the JAX package's ``parallel/distribute.py``.  The port runs
one process on one card: the rank is 0, the world has one member and
``reduce_dict`` is the identity.  A process group of several members (DDP
over NCCL) is not ported yet, and ``reduce_dict`` raises under one.
"""
from __future__ import annotations

from typing import Dict

import torch.distributed as dist


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def reduce_dict(input_dict: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Average (or sum) python-scalar metrics across processes: the identity
    for one process."""
    if get_world_size() > 1:
        raise NotImplementedError(
            "reduce_dict over several processes waits for multi-GPU (ROADMAP queue 1, item 7)")
    return dict(input_dict)


def get_reduced_loss(loss_dict, weight_dict, metric_logger, prefix: str = "") -> float:
    """Log the scaled and unscaled losses; return the weighted total."""
    reduced = reduce_dict({k: float(v) for k, v in loss_dict.items()})
    unscaled = {f"{prefix}{k}_unscaled": v for k, v in reduced.items()}
    scaled = {f"{prefix}{k}": v * weight_dict[k] for k, v in reduced.items() if k in weight_dict}
    if metric_logger is not None:
        metric_logger.update(**unscaled)
        metric_logger.update(**scaled)
    return float(sum(scaled.values()))
