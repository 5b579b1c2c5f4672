#!/usr/bin/env python3
"""What one span of the port (``utils.profiler.annotate``) costs the host.

Times ``--n`` empty spans back to back on the host clock three ways: with
the torch profiler off (two clock reads and an add to ``SPANS``), with it
on (a ``record_function`` range as well), and a bare ``record_function``
with the profiler off (the dispatcher call the span avoids).  It also
checks whether a ``record_function`` range opened on a thread started
inside the profiler reaches the exported trace.  Prints one JSON line; on a
machine with a card, the card's name and power limit on standard error.

    python3 tools/span_cost_torch.py [--n 100000]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    annotate,
    card_line,
)


def us_each(fn, n: int) -> float:
    """Mean µs of ``n`` calls of ``fn`` after ``n // 10`` warm-up calls."""
    for _ in range(n // 10):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def span() -> None:
    with annotate("span_cost"):
        pass


def bare_range() -> None:
    with torch.profiler.record_function("span_cost"):
        pass


def thread_range_reaches_trace() -> bool:
    """A ``record_function`` range on a thread started inside the profiler,
    looked for in the exported trace."""
    def work():
        with torch.profiler.record_function("span_cost.thread"):
            torch.ones(8).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text())["traceEvents"]
    return any(e.get("name") == "span_cost.thread" for e in events)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100_000)
    n = p.parse_args().n
    out = {"torch": torch.__version__, "n": n, "span_off_us": us_each(span, n),
           "record_function_off_us": us_each(bare_range, n)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        print(card_line(), file=sys.stderr)
    with torch.profiler.profile(activities=acts):
        out["span_on_us"] = us_each(span, n)
    out["thread_range_in_trace"] = thread_range_reaches_trace()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
