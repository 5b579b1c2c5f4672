"""Training meters.

Counterpart of the JAX package's ``utils/meters.py``: ``SmoothedValue``
keeps a window of recent values plus global totals, ``MetricLogger`` groups
meters into one line, ``Heartbeat`` logs progress without touching the
device, and ``DeviceMetricAccumulator`` sums each step's metric tensors on
the device and fetches them once (the span ``train.fetch``).  Over several
processes both reduce over the data axis' ranks (one per batch shard) in
one collective each.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..parallel.distribute import comm_device, data_group, data_world
from .profiler import annotate


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AverageMeterSet:
    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def __getitem__(self, key):
        if key not in self.meters:
            self.meters[key] = AverageMeter()
        return self.meters[key]

    def update(self, name, value, n=1):
        self[name].update(value, n)

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def values(self, postfix=""):
        return {name + postfix: m.val for name, m in self.meters.items()}

    def averages(self, postfix="/avg"):
        return {name + postfix: m.avg for name, m in self.meters.items()}


class SmoothedValue:
    """Windowed median/avg plus global totals."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum (count, total) over the processes in one ``all_reduce``; the
        window stays this process's."""
        if data_world() == 1:
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=comm_device())
        dist.all_reduce(t, group=data_group())
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class Heartbeat:
    """Time-based progress line within an epoch, from the host clock and the
    count of issued steps only: it never waits for the device."""

    def __init__(self, log_fn, total_steps: int, interval_s: float = 60.0):
        self.log_fn = log_fn
        self.total = total_steps
        self.interval_s = interval_s
        self._t0 = time.time()
        self._last = self._t0

    def tick(self, i: int) -> None:
        """Call once per step with the 0-based step index."""
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self._last = now
        done = i + 1
        rate = done / max(now - self._t0, 1e-9)
        eta = (self.total - done) / max(rate, 1e-9)
        self.log_fn(f"  [{done}/{self.total}] {rate:.2f} steps/s issued, "
                    f"eta {datetime.timedelta(seconds=int(eta))}")


class DeviceMetricAccumulator:
    """Sums each step's metric dict on the device; one fetch per epoch.

    ``update`` adds the step's tensors (weighted) with one foreach kernel and
    never waits for the device; ``totals`` packs the sums and copies them to
    the host in one transfer.  A NaN in any step stays in its sum, so the
    epoch-end check still sees it.

    Over several processes ``totals`` and ``means`` sum the ranks' sums in
    one ``all_reduce`` (every rank must have updated with the same keys).
    ``partials``: each update is this rank's partial of one global value (a
    train step's metrics), so the weights are not summed over the ranks;
    otherwise each rank's updates are rows of their own (the evaluation's
    batches) and the weights are summed too.
    """

    def __init__(self, partials: bool = False):
        self.partials = partials
        self._keys = None
        self._sum = None
        self._n = 0
        self._w = 0.0

    def update(self, metrics: Dict[str, torch.Tensor], weight: float = 1.0) -> None:
        """Add one step's metrics, scaled by ``weight``; ``means`` divides by
        the total weight.  The eval loop weights each batch by its real
        (unpadded) rows."""
        self._n += 1
        self._w += weight
        if self._sum is None:
            self._keys = sorted(metrics)
            self._sum = [metrics[k].detach().float() * weight for k in self._keys]
        else:
            torch._foreach_add_(self._sum, [metrics[k].detach().float() for k in self._keys],
                                alpha=weight)

    @property
    def steps(self) -> int:
        return self._n

    def _reduced(self):
        """(the sums, the total weight) as float64 numpy, over the ranks: one
        packed vector, one collective, one device-to-host copy, in the span
        ``train.fetch`` (the copy waits for the device's queued work)."""
        if not self._n:
            return {}, self._w
        with annotate("train.fetch"):
            flat = torch.cat([v.reshape(-1).double() for v in self._sum]
                             + [torch.tensor([self._w], dtype=torch.float64,
                                             device=self._sum[0].device)])
            if data_world() > 1:
                flat = flat.to(comm_device())
                dist.all_reduce(flat, group=data_group())
            flat = flat.cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        start = 0
        for k, v in zip(self._keys, self._sum):
            out[k] = flat[start] if v.dim() == 0 else flat[start:start + v.numel()].reshape(v.shape)
            start += v.numel()
        return out, (self._w if self.partials else float(flat[-1]))

    def totals(self) -> Dict[str, np.ndarray]:
        """The sums (over the ranks) as numpy, in one device-to-host copy."""
        return self._reduced()[0]

    def means(self):
        """(weight-normalized means, step count); one fetch."""
        t, w = self._reduced()
        denom = w if w > 0 else max(self._n, 1)
        return {k: v / denom for k, v in t.items()}, self._n


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def add_meter(self, name, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()
