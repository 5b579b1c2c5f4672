"""Profiling hooks and timers: ``torch.profiler`` traces, the port's spans,
step timing, device times and a report of a trace.

Counterpart of the JAX package's ``utils/profiler.py``.  ``trace`` writes a
Chrome trace (viewable in Perfetto or TensorBoard) of the code inside it;
``annotate`` is the span: a named range on that timeline while the profiler
runs, and always a host-clock total per name in ``SPANS``; ``StepTimer``
keeps an epoch's data-time and batch-time meters and its spans.

The spans, fixed names opened by the training loop and step:

* ``train_lib._epoch_loop``, the loop of ``train_one_epoch`` and
  ``train_audio_tag_epoch``: ``train.epoch`` (the call), ``train.wait``
  (from a step's end to the next batch: the wait on the prefetch queue,
  which frees the batch before it; the first starts the prefetch thread),
  ``train.gather`` (``FeatureBank.gather``, with a bank), ``train.step``
  (the step call);
* ``engine.make_train_step``: ``train.augment``, ``train.forward`` (the
  model, with SP-SEDT's crop), ``train.criterion`` (``set_criterion``: the
  matching and its losses), ``train.backward``, ``train.optimizer`` on its
  eager calls and captures; ``train.replay`` (a CUDA graph's replay, which
  runs those parts without their spans);
* ``meters.DeviceMetricAccumulator``: ``train.fetch`` (the meter's one
  device-to-host copy, which waits for the device);
* ``data.dataset.batch_iterator``, on the prefetch thread: ``data.batch``
  (one batch's targets or patch boxes, collate and pin);
* ``train_lib.make_audio_tag_step``: ``train.forward`` (the model and the
  BCE), ``train.backward``, ``train.optimizer``;
* ``ops.flash_attention``'s backward: ``attention.backward`` (K4's
  recompute of the plain attention and its gradient, on autograd's thread);
* ``predict_cli.predict_batches``: ``predict.copy`` (a batch of waveforms
  to the device) and ``predict.decode`` (a batch's host decode).

The timers the measuring tools (``tools/*_torch.py``) and ``chip_smoke.py``
share live here too: ``cuda_ms`` (CUDA events around back-to-back calls: the
host's issue time when the path is host-bound), ``device_ms`` (a replayed
CUDA graph: a kernel's own time), ``record`` and ``busy_ms`` (the kernels'
and copies' rows and time under the profiler: a path's device time),
``measure`` (both readings of one function, or the host clock on the CPU),
``kernel_kinds`` and ``trace_table`` (device time by kernel kind, from the
profiler's rows or from a written trace) and ``card_line``.

The module imports no other module of the port at load, and none of the
layers above it at all, so that every layer can open spans.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import math
import os
import subprocess
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as autograd_profiler


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


# ------------------------------------------------------------------- spans

# the spans a log keeps: many thousands of steps, so that a stretch of time
# can be read back after it ended (``Spans.between``)
SPAN_LOG = 1 << 16


class SpanTotal(NamedTuple):
    """How many spans of one name ended, and their seconds on the host clock."""

    count: int
    seconds: float


class Spans:
    """Per-name totals of the spans that ended, on the host clock
    (``time.perf_counter``), written from any thread, and a log of the
    latest ``keep`` spans ``(name, start, end)``.  ``totals`` is a snapshot
    that ``since`` diffs; ``between`` reads a stretch of time after it
    ended, from the log."""

    def __init__(self, keep: int = SPAN_LOG):
        self._lock = threading.Lock()
        self._totals: Dict[str, List] = {}
        self._log: collections.deque = collections.deque(maxlen=keep)

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            total = self._totals.get(name)
            if total is None:
                self._totals[name] = [1, end - start]
            else:
                total[0] += 1
                total[1] += end - start
            self._log.append((name, start, end))

    def totals(self) -> Dict[str, SpanTotal]:
        with self._lock:
            return {k: SpanTotal(*v) for k, v in self._totals.items()}

    def since(self, before: Dict[str, SpanTotal]) -> Dict[str, SpanTotal]:
        """The totals of the spans that ended since the snapshot ``before``."""
        out = {}
        for name, (n, s) in self.totals().items():
            n0, s0 = before.get(name, (0, 0.0))
            if n > n0:
                out[name] = SpanTotal(n - n0, s - s0)
        return out

    def between(self, start: float, end: float) -> Optional[Dict[str, SpanTotal]]:
        """The totals of the spans that began and ended inside ``[start,
        end]`` (``time.perf_counter`` seconds); None when the log no longer
        reaches back to ``start``."""
        with self._lock:
            log = list(self._log)
        if len(log) == self._log.maxlen and log[0][1] > start:
            return None
        out: Dict[str, List] = {}
        for name, a, b in log:
            if a >= start and b <= end:
                total = out.setdefault(name, [0, 0.0])
                total[0] += 1
                total[1] += b - a
        return {k: SpanTotal(*v) for k, v in out.items()}


# the process's spans: every layer opens them, none is handed a recorder
SPANS = Spans()
_MAIN_THREAD = threading.main_thread()


class annotate:
    """The span ``name``: a context manager that adds its host-clock
    seconds to ``SPANS``, and while the torch profiler runs opens a
    ``record_function`` range of that name, a ``user_annotation`` on the
    trace's own clock, which the device's events share.  Only the main
    thread's spans open a range: the profiler keeps none from a thread that
    started inside it (the prefetch thread starts each epoch), and another
    thread's range would name the main thread's idle gaps.  ``any_thread``
    opens it on any thread, for a span inside autograd's backward, which on
    the card runs on autograd's own device thread (the profiler's state
    follows the backward there).

    With the profiler off a span costs two clock reads and an add, and no
    dispatcher call.  It never synchronises the device.  A span that ends by
    an exception is left out of the totals (its range, if open, still ends).
    ``seconds`` holds the span's time once it has ended.
    """

    __slots__ = ("name", "start", "seconds", "_range", "_any_thread")

    def __init__(self, name: str, any_thread: bool = False):
        self.name = name
        self._range = None
        self._any_thread = any_thread

    def __enter__(self) -> "annotate":
        if (autograd_profiler._is_profiler_enabled
                and (self._any_thread or threading.current_thread() is _MAIN_THREAD)):
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        self.seconds = end - self.start
        if exc_type is None:
            SPANS.add(self.name, self.start, end)


# the spans of one training step, in the order the epoch line prints them
STEP_SPANS = ("train.wait", "train.gather", "train.step", "train.replay", "train.augment",
              "train.forward", "train.criterion", "train.backward", "train.optimizer")


class StepTimer:
    """An epoch's timers on the host clock: ``data_time``, each batch's wait
    (the seconds of its ``train.wait`` span, so it equals those spans'
    totals), ``batch_time`` from one step's end to the next's, and the
    spans' totals since the timer started (``spans``).

    The train loop makes no host sync per step, so a step returns once its
    kernels are queued: ``batch_time`` and the step's spans measure the
    host's issue time, not the card's.  The step time is the epoch's wall
    time over its steps (the epoch line), which ends in the one sync of the
    epoch, ``train.fetch``.
    """

    def __init__(self):
        from .meters import AverageMeter  # meters opens spans of this module

        self.data_time = AverageMeter()
        self.batch_time = AverageMeter()
        self._spans = SPANS.totals()
        self._end = time.perf_counter()

    def data_loaded(self, seconds: float) -> None:
        """A batch arrived after a wait of ``seconds``."""
        self.data_time.update(seconds)

    def step_done(self) -> None:
        now = time.perf_counter()
        self.batch_time.update(now - self._end)
        self._end = now

    def spans(self) -> Dict[str, SpanTotal]:
        return SPANS.since(self._spans)

    def summary(self) -> str:
        """The meters, then each step span's mean ms, the fetch's and the
        prefetch thread's mean ms a batch (``data.batch``), as far as they
        ran since the timer started."""
        spans = self.spans()
        parts = [f"{n.split('.', 1)[1]} {1e3 * spans[n].seconds / spans[n].count:.1f}"
                 for n in STEP_SPANS + ("train.fetch", "data.batch") if n in spans]
        return (
            f"data_time:{self.data_time.val:.3f}({self.data_time.avg:.3f}) "
            f"batch_time:{self.batch_time.val:.3f}({self.batch_time.avg:.3f}) "
            f"spans ms: {', '.join(parts)}"
        )


# ---------------------------------------------------------------- timers


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean ms of device time per call of ``fn``: ``calls`` calls are captured
    into one CUDA graph, which is replayed between two events, so the host's
    time to start a launch (tens of microseconds from Python, more than some
    of these kernels run) stays out of the figure.  The launches land on the
    capture stream because the wrappers launch on PyTorch's current stream."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


# the least window ``record`` keeps: the profiler now and then drops a run of
# device records, which cost a window of a few kernels all of them and one
# profiled SP-SEDT step 8 % of its time, so a window holds at least
# ``LEAST_CALLS`` calls and ``LEAST_WINDOW_MS`` of wall time (a longer floor
# costs the profiler's own processing of the host's events more than it runs)
LEAST_CALLS = 3
LEAST_WINDOW_MS = 50.0


class Recording(NamedTuple):
    """The device's own records of ``calls`` calls under the profiler:
    ``rows`` (kernel or copy name, µs, count) summed over the calls, the
    largest first; ``wall_ms`` the calls' wall time; ``table`` the
    profiler's table of the window by device time."""

    rows: List[tuple]
    wall_ms: float
    calls: int
    table: str

    @property
    def busy_ms(self) -> float:
        """Device time per call."""
        return sum(r[1] for r in self.rows) / self.calls / 1e3


def record(fn, once: bool = False) -> Recording:
    """Calls of ``fn`` under the profiler after a warm-up cycle of as many,
    its device rows kept: kernels and copies (an operator's row repeats the
    device time of the kernels it launched, and a user annotation on the
    device's timeline spans kernels already counted).  The window holds at
    least ``LEAST_CALLS`` calls and ``LEAST_WINDOW_MS`` of wall time, judged
    by one call first; with ``once`` (a call that may run only once, as a
    trainer's epoch) it holds one call and the warm-up cycle is empty."""
    calls = 1
    if not once:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once_ms = (time.perf_counter() - t0) * 1e3
        calls = max(LEAST_CALLS, math.ceil(LEAST_WINDOW_MS / max(once_ms, 1e-3)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    warm_then_record = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=warm_then_record) as prof:
        for cycle in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(0 if once and not cycle else calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    averages = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)), key=lambda r: -r[1])
    return Recording(rows, wall_ms, calls,
                     averages.table(sort_by="self_device_time_total", row_limit=40))


def busy_ms(fn) -> float:
    """Device time per call of ``fn`` under the profiler (:func:`record`'s
    least window): its kernels' and copies' time, summed."""
    return record(fn).busy_ms


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the host clock (the CPU: no device)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


class Reading(NamedTuple):
    """Two readings of one function: ``ms`` per call (CUDA events around
    back-to-back calls on the card, the host clock on the CPU) and
    ``device_ms`` per call (``busy_ms``, or ``device_ms`` with ``graph``;
    None on the CPU, which has no device time); ``calls`` is how many calls
    the two took."""

    ms: float
    device_ms: Optional[float]
    calls: int


def measure(fn, iters: int, device: torch.device, warmup: int = 3,
            graph: bool = False) -> Reading:
    """Both readings of ``fn`` on ``device`` (see :class:`Reading`).  A path
    that the host holds back reads more by ``ms`` than by ``device_ms``."""
    calls = [0]

    def counted():
        calls[0] += 1
        return fn()

    if device.type != "cuda":
        return Reading(host_ms(counted, iters, warmup), None, calls[0])
    ms = cuda_ms(counted, iters, warmup)
    dev_ms = device_ms(counted) if graph else busy_ms(counted)
    return Reading(ms, dev_ms, calls[0])


def card_of(device: torch.device) -> str:
    """What a tool prints beside each time: the card's line, or that the
    times are the host's."""
    return card_line() if device.type == "cuda" else "CPU, host clock, no device time"


# -------------------------------------------------------- time by kernel kind

# kernel names by kind, the first match deciding (lower case); the rest are
# elementwise kernels.  The port's own kernels come first: ``csrc/*.cu``.
# cuDNN's and cuBLAS's Hopper kernels both say ``xmma`` (``sm90_xmma_fprop_
# implicit_gemm...``, ``sm90_xmma_gemm...``), so a convolution is told by its
# pass or its library and ``xmma`` alone means a matrix product.  The names
# cannot tell every case: cuDNN runs some 1x1 convolutions as plain GEMM
# kernels (``sm90_xmma_gemm_..._cublas``), and those count as matmuls.
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
    """The kind of a kernel by its name (``KERNEL_KINDS``)."""
    name = name.lower()
    return next((k for k, pats in KERNEL_KINDS if any(p in name for p in pats)), OTHER_KIND)


def kernel_kinds(rows: list, calls: int) -> dict:
    """Device rows ``(name, µs, count)`` over ``calls`` calls summed by
    ``KERNEL_KINDS``: {kind: (ms each call, launches each call)}."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for key, us, count in rows:
        kind = kernel_kind(key)
        out[kind][0] += us / calls / 1e3
        out[kind][1] += count // calls
    return {k: tuple(v) for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


# ------------------------------------------------------------ Chrome traces

# the device's own events in torch's Chrome trace; ``gpu_user_annotation``
# spans cover the kernels of an ``annotate`` range and would count them twice
DEVICE_CATEGORIES = {"kernel": None, "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATEGORY = "cpu_op"


def find_trace(trace_dir: str) -> str:
    """The newest ``*.pt.trace.json`` (or ``.json.gz``) under ``trace_dir``."""
    paths = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _trace_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union_us(spans: List[tuple]) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def trace_table(path: str, raw: bool = False, top: int = 30, all_planes: bool = False) -> Dict:
    """Device time of a ``torch.profiler`` Chrome trace by kernel kind (by
    kernel name with ``raw``), per device and stream: the counterpart of
    ``tools/xplane_report.py``'s table.  Only ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset`` events count (copies are the kind ``copy``); with
    ``all_planes`` the host's ``cpu_op`` events count too, as the plane
    ``host`` (they nest, so their shares overlap).  ``ts`` and ``dur`` are
    µs.

    Returns ``{"path", "window_ms", "busy_ms", "planes": {plane: {"total_ms",
    "rows": [(name, ms, share of the plane, count), ...]}}}``, the rows the
    ``top`` largest; ``window_ms`` spans every timed event, ``busy_ms`` is the
    union of the device events over it.  Raises when no plane has an event
    (the trace saw no device without ``all_planes``)."""
    events = [e for e in _trace_events(path) if e.get("ph") == "X" and "dur" in e]
    planes: Dict[str, Dict[str, list]] = {}
    device_spans = []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            args = e.get("args", {})
            plane = (f"GPU {args.get('device', e.get('pid'))} stream "
                     f"{args.get('stream', e.get('tid'))}")
            key = e["name"] if raw else (DEVICE_CATEGORIES[cat] or kernel_kind(e["name"]))
            device_spans.append((e["ts"], e["ts"] + e["dur"]))
        elif all_planes and cat == HOST_CATEGORY:
            plane, key = "host", e["name"]
        else:
            continue
        row = planes.setdefault(plane, {}).setdefault(key, [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    if not planes:
        cats = sorted({e.get("cat", "?") for e in events})
        raise RuntimeError(f"no device events found in {path}; categories = {cats}")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    out = {"path": path, "window_ms": (t1 - t0) / 1e3, "busy_ms": _union_us(device_spans) / 1e3,
           "planes": {}}
    for plane, rows in sorted(planes.items()):
        total = sum(us for us, _ in rows.values())
        ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]
        out["planes"][plane] = {
            "total_ms": total / 1e3,
            "rows": [(k, us / 1e3, us / total if total else 0.0, n) for k, (us, n) in ranked]}
    return out
