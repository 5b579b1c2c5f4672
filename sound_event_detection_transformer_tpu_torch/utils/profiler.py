"""Profiling hooks: ``torch.profiler`` traces, named ranges and step timing.

Counterpart of the JAX package's ``utils/profiler.py``.  ``trace`` writes a
Chrome trace (viewable in Perfetto or TensorBoard) of the code inside it;
``annotate`` names a range on that timeline; ``StepTimer`` keeps the
data-time and batch-time meters on the host clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

from .meters import AverageMeter


@contextlib.contextmanager
def trace(log_dir: str = "build/torch_trace") -> Iterator[torch.profiler.profile]:
    """Trace the host and the card around a code block into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range inside a trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """data_time / batch_time meters on the host clock.

    The train loop makes no host sync per step, so a step returns once its
    kernels are queued: ``batch_time`` measures the host's issue time, not
    the card's.  The step time is the epoch's wall time over its steps (the
    epoch line), which ends in the one sync of the epoch.
    """

    def __init__(self):
        self.data_time = AverageMeter()
        self.batch_time = AverageMeter()
        self._end = time.time()

    def data_loaded(self):
        self.data_time.update(time.time() - self._end)

    def step_done(self):
        self.batch_time.update(time.time() - self._end)
        self._end = time.time()

    def summary(self) -> str:
        return (
            f"data_time:{self.data_time.val:.3f}({self.data_time.avg:.3f}) "
            f"batch_time:{self.batch_time.val:.3f}({self.batch_time.avg:.3f})"
        )
