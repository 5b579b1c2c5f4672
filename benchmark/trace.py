"""The profiled stretch of a traced run, read from ``torch.profiler``'s
Chrome trace: the device's events inside the stretch, their busy union,
time by kernel kind, and the breakdown that the result line carries.

Only the device's own events count: ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` (a ``gpu_user_annotation`` spans kernels already counted).
The stretch is the host span of the ``STRETCH`` annotation that the entry
puts around its recorded steps, which start and end with the device idle.
``KERNEL_KINDS`` is a frozen copy of the port's table (PR 13), so a change
to the port's table cannot move these readings.
"""
from __future__ import annotations

import collections
import gzip
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

STRETCH = "benchmark.stretch"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")

# the first match decides (lower case); the rest are "elementwise and other".
# cuDNN's and cuBLAS's Hopper kernels both say ``xmma``, so a convolution is
# told by its pass or its library; cuDNN's 1x1 convolutions run as plain
# GEMMs count as matmuls.
KERNEL_KINDS = (("hand-written", ("jv_warp_kernel", "jv_block_kernel", "jv_square_kernel",
                                  "flash_mma_kernel", "flash_combine_kernel", "flash_kernel")),
                ("copy", ("memcpy", "memset")),
                ("layout transpose", ("nchwtonhwc", "nhwctonchw")),
                ("convolution", ("conv", "implicit", "cudnn", "wgrad", "dgrad", "fprop")),
                ("matmul", ("gemm", "cublas", "cutlass", "xmma")),
                ("Adam", ("adam",)),
                ("reduction", ("reduce", "norm")))
OTHER_KIND = "elementwise and other"


def kernel_kind(name: str) -> str:
    name = name.lower()
    return next((k for k, pats in KERNEL_KINDS if any(p in name for p in pats)), OTHER_KIND)


class Event(NamedTuple):
    name: str
    cat: str
    ts: float  # µs
    dur: float  # µs


class Trace(NamedTuple):
    """A stretch of ``steps`` steps: its device and host events and its span."""

    device: List[Event]
    host: List[Event]
    start: float  # µs
    end: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def load(path: str, steps: int) -> Trace:
    """The events of a Chrome trace inside its ``STRETCH`` span."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    raw = data["traceEvents"] if isinstance(data, dict) else data
    events = [Event(e["name"], e.get("cat", ""), float(e["ts"]), float(e["dur"]))
              for e in raw if e.get("ph") == "X" and "dur" in e]
    return from_events(events, steps)


def from_events(events: List[Event], steps: int) -> Trace:
    spans = [e for e in events if e.name == STRETCH and e.cat in HOST_CATEGORIES]
    if not spans:
        raise ValueError(f"the trace has no {STRETCH!r} span")
    span = max(spans, key=lambda e: e.ts)
    lo, hi = span.ts, span.ts + span.dur
    inside = lambda e: e.ts >= lo and e.ts + e.dur <= hi
    device = [e for e in events if e.cat in DEVICE_CATEGORIES and inside(e)]
    host = [e for e in events if e.cat in HOST_CATEGORIES and inside(e) and e is not span]
    return Trace(device, host, lo, hi, steps)


def busy_spans(tr: Trace) -> List[Tuple[float, float]]:
    """The union of the device's events as disjoint (start, end) spans."""
    out: List[List[float]] = []
    for e in sorted(tr.device, key=lambda e: e.ts):
        if out and e.ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.ts + e.dur)
        else:
            out.append([e.ts, e.ts + e.dur])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_spans(tr)) / 1e6


def kind_ms_per_step(tr: Trace) -> Dict[str, float]:
    out: Dict[str, float] = collections.defaultdict(float)
    for e in tr.device:
        out["copy" if e.cat != "kernel" else kernel_kind(e.name)] += e.dur / 1e3 / tr.steps
    return dict(out)


def kernels(tr: Trace) -> List[Event]:
    return [e for e in tr.device if e.cat == "kernel"]


def _host_at(tr: Trace, t: float) -> str:
    """The innermost host event running at ``t`` (the latest to start)."""
    live = [e for e in tr.host if e.ts <= t < e.ts + e.dur]
    return max(live, key=lambda e: e.ts).name[:120] if live else "no host event"


def breakdown(tr: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing in their middle, each in seconds."""
    ops: Dict[str, float] = collections.defaultdict(float)
    for e in tr.device:
        ops[e.name[:120]] += e.dur / 1e6
    gaps: Dict[str, float] = collections.defaultdict(float)
    edge = tr.start
    for a, b in busy_spans(tr) + [(tr.end, tr.end)]:
        if a > edge:
            gaps[_host_at(tr, (edge + a) / 2)] += (a - edge) / 1e6
        edge = max(edge, b)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def find(tr: Optional[Trace], pattern) -> List[Event]:
    """The kernel events whose name matches the compiled regex ``pattern``."""
    return [] if tr is None else [e for e in kernels(tr) if pattern.search(e.name)]
