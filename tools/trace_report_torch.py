#!/usr/bin/env python3
"""Device time by kernel kind (or name) from a ``torch.profiler`` trace.

The port's counterpart of ``tools/xplane_report.py``: it reads the newest
``*.pt.trace.json`` (or ``.json.gz``) under a directory, such as the one
``tools/capture_trace_torch.py`` writes, sums the device's kernel, copy and
memset events by kind (``utils.profiler.KERNEL_KINDS``; by kernel name with
``--raw``) per device and stream, and prints each plane's total and its
``--top`` rows: total ms, share and count.  The ``gpu_user_annotation``
spans that cover an ``annotate`` range's kernels are left out, so nothing
counts twice.  The header gives the traced window and the device's busy
share of it.  ``--all_planes`` adds the host's ``cpu_op`` events (which
nest).  A trace without device events raises.

    python3 tools/trace_report_torch.py build/torch_trace [--top 30] [--raw]

It reads a file and needs no card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    find_trace,
    trace_table,
)


def report_lines(table: dict) -> list:
    """``trace_table``'s result as ``xplane_report``'s lines."""
    share = table["busy_ms"] / table["window_ms"] if table["window_ms"] else 0.0
    lines = [f"# {table['path']}: window {table['window_ms']:.3f} ms, device busy "
             f"{table['busy_ms']:.3f} ms ({100 * share:.1f}%)"]
    for plane, p in table["planes"].items():
        lines.append(f"\n== plane: {plane}  total {p['total_ms']:.3f} ms")
        lines += [f"  {ms:9.3f} ms  {100 * frac:5.1f}%  x{n:<6d} {name}"
                  for name, ms, frac, n in p["rows"]]
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--raw", action="store_true", help="report kernel names, not kinds")
    ap.add_argument("--all_planes", "--all-planes", action="store_true",
                    help="also report the host's cpu_op events")
    args = ap.parse_args(argv)
    table = trace_table(find_trace(args.trace_dir), args.raw, args.top, args.all_planes)
    print("\n".join(report_lines(table)))
    return table


if __name__ == "__main__":
    main()
