"""The program's spans in a run: the window's host-clock totals, read back
from the program's span log by the window's clock bounds, and the profiled
stretch's idle time put down to the ``train.*`` ranges that the spans open
on the trace's clock.

A program without spans gives nothing to read: ``window_spans`` then
returns None and ``idle_parts`` finds no ``train.step`` range, so each
reader returns None and prints nothing.  Times in the trace are µs.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from .trace import Trace, busy_spans

Interval = Tuple[float, float]
PREFIX = "train."
# the idle parts, which add up to the stretch's idle time when the ranges
# nest as the loop opens them (wait, gather and step inside train.epoch, the
# fetch after it)
PARTS = ("issue", "data", "edge", "epoch", "outside")


def window_spans(run: Dict) -> Optional[Dict[str, Tuple[int, float]]]:
    """Each span's (count, seconds) that began and ended inside the window,
    or None where the program keeps no span log."""
    from sound_event_detection_transformer_tpu_torch.utils import profiler

    spans = getattr(profiler, "SPANS", None)
    w = run["window"]
    return None if spans is None else spans.between(w["t0"], w["t0"] + w["window_s"])


def mean_ms(run: Dict, name: str) -> Optional[float]:
    """The mean ms of span ``name`` over the window."""
    spans = window_spans(run)
    if not spans or name not in spans:
        return None
    count, seconds = spans[name]
    return 1e3 * seconds / count


def report_window(run: Dict) -> None:
    """Each span's ms a step over the window, on standard error."""
    spans, steps = window_spans(run), run["window"]["steps"]
    if not spans or not steps:
        return
    parts = ", ".join(f"{k} {1e3 * s / steps:.3f} ({n})" for k, (n, s) in sorted(spans.items()))
    print(f"spans over the window, ms a step (count): {parts}", file=sys.stderr)


def ranges(tr: Trace, name: str) -> List[Interval]:
    """The host ranges named ``name`` in the stretch, by start."""
    return sorted((e.ts, e.ts + e.dur) for e in tr.host if e.name == name)


def union(spans: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(x: List[Interval], y: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def measure(spans: List[Interval]) -> float:
    return sum(b - a for a, b in spans)


def idle(tr: Trace) -> List[Interval]:
    """The stretch's stretches with no device event running."""
    out, edge = [], tr.start
    for a, b in busy_spans(tr) + [(tr.end, tr.end)]:
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    return out


def idle_parts(tr: Optional[Trace]) -> Optional[Dict[str, float]]:
    """The stretch's idle µs (``idle``) and its parts by the ranges it
    overlaps: ``issue`` the ``train.step`` ranges; ``data`` ``train.gather``
    and every ``train.wait`` but the first (the loop's last, ended wait for
    no batch among them: the trace keeps its range); ``edge`` the first
    ``train.wait`` (the prefetch thread's start) and ``train.fetch``;
    ``epoch`` ``train.epoch`` outside its wait, gather and step ranges;
    ``outside`` no ``train.*`` range.  None without a ``train.step`` range."""
    if tr is None:
        return None
    steps = ranges(tr, "train.step")
    if not steps:
        return None
    waits, gathers = ranges(tr, "train.wait"), ranges(tr, "train.gather")
    gaps = idle(tr)
    over = lambda spans: measure(intersect(gaps, union(spans)))
    in_epoch = intersect(gaps, union(ranges(tr, "train.epoch")))
    named = [(e.ts, e.ts + e.dur) for e in tr.host if e.name.startswith(PREFIX)]
    total = measure(gaps)
    return {"idle": total,
            "issue": over(steps),
            "data": over(gathers + waits[1:]),
            "edge": over(waits[:1] + ranges(tr, "train.fetch")),
            "epoch": measure(in_epoch) - measure(intersect(in_epoch,
                                                           union(steps + waits + gathers))),
            "outside": total - over(named)}


def report_idle(tr: Optional[Trace]) -> None:
    """The stretch's idle parts on standard error: what the idle outside
    program spans is, whether the parts add up, and the step ranges
    against the stretch's steps."""
    parts = idle_parts(tr)
    if parts is None:
        return
    total = parts["idle"]
    share = 100.0 * parts["outside"] / total if total else 0.0
    listed = ", ".join(f"{k} {parts[k] / 1e3:.3f}" for k in PARTS)
    print(f"idle outside program spans: {parts['outside'] / 1e3:.3f} ms, {share:.2f} % of the "
          f"stretch's idle {total / 1e3:.3f} ms; idle parts, ms: {listed}, adding up to "
          f"{sum(parts[k] for k in PARTS) / 1e3:.3f}; train.step ranges "
          f"{len(ranges(tr, 'train.step'))} for {tr.steps} steps", file=sys.stderr)
