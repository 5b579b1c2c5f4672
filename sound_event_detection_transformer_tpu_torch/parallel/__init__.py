"""Training-side parallel utilities of the port: the optimizer (masked
two-group AdamW with its clip, schedules and accumulation) and the EMA; the
process group, its (data x model) layout and its collectives
(``distribute``), each data rank's share of a batch, the tensor-parallel cut
of the model and the DDP wrapper (``mesh``), the tensor-parallel
all_reduces (``tensor``), and the multi-process dryrun's legs
(``dryrun``)."""
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
