"""Training-side parallel utilities of the port: so far the optimizer (masked
two-group AdamW with its clip, schedules and accumulation) and the EMA."""
from .optim import (
    SEDTOptimizer,
    clip_by_global_norm_,
    cosine_lr,
    ema_update,
    label_params,
    make_optimizer,
    param_label,
    step_lr,
)

__all__ = [
    "SEDTOptimizer",
    "clip_by_global_norm_",
    "cosine_lr",
    "ema_update",
    "label_params",
    "make_optimizer",
    "param_label",
    "step_lr",
]
