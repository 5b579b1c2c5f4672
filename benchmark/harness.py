"""The benchmark's driver: one run of one cell.

Everything that belongs to one part is found by name: a cell in
``workloads/<cell>.json`` (its configuration, traffic, entry, chips and
limits), a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, an entry in ``entries/<name>.py`` (``run`` and
``check``) and each metric's reader in ``metrics/<name>.py``.  Which
metrics a cell reports comes from ``BENCHMARK.json``: its end-to-end
metrics in an untraced run, its per-layer metrics in a traced one.
"""
from __future__ import annotations

import importlib
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sound_event_detection_transformer_tpu")


def load(kind: str, name: str) -> Dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark_file() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(cell: str, traced: bool, bench: Dict) -> List[Dict]:
    """The metrics ``cell`` reports in an untraced or a traced run."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """JAX, flax and the JAX package among the loaded modules, by whole
    top-level name (the port's name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_metrics(specs: List[Dict], run: Dict) -> Dict[str, Dict]:
    out = {}
    for spec in specs:
        reader = importlib.import_module(f"benchmark.metrics.{spec['name']}")
        value = reader.read(run)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, workload: Optional[Dict] = None, config: Optional[Dict] = None,
             traffic: Optional[Dict] = None, specs: Optional[List[Dict]] = None
             ) -> Tuple[Dict, List[str]]:
    """One run: (the result object, the lines of the comparison).  The
    workload, configuration, traffic and metric specs are found by name
    unless given."""
    workload = workload or load("workloads", cell)
    config = config or load("configs", workload["config"])
    traffic = traffic or load("traffic", workload["traffic"])
    specs = specs if specs is not None else metrics_of(cell, traced, benchmark_file())
    entry = importlib.import_module(f"benchmark.entries.{workload['entry']}")
    out = entry.run(config, traffic, seed, seconds, traced, device)
    run = {"config": config, "traffic": traffic, "window": out["window"], "trace": out["trace"],
           "setup_s": out["window"]["t0"] - t_start}
    metrics = read_metrics(specs, run)
    found = entry.check(config, traffic, seed, device, out)
    parts = dict(out["setup_parts"])
    parts["imports and CUDA"] -= t_start
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()), file=sys.stderr)
    iv = out["window"]["intervals_ms"]
    if iv:
        q = np.percentile(iv, [10, 50, 90, 99])
        print(f"step intervals: {len(iv)}, p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f} "
              f"p99 {q[3]:.2f} max {max(iv):.2f} ms", file=sys.stderr)
    checks, lines, correct = {}, [], out["failed"] == 0
    for name, reading in found.items():
        if name not in workload["limits"]:  # reported, not compared
            steps = f"; by step {reading['steps']}" if "steps" in reading else ""
            print(f"{name} {reading['value']!r} not compared ({reading['at']}{steps})",
                  file=sys.stderr)
            continue
        limit = workload["limits"][name]
        value = reading["value"]
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value if math.isfinite(value) else str(value), "limit": limit}
        lines.append(f"{name} {value!r} limit {limit!r} ({reading['at']}){'' if ok else ' FAILED'}")
    missing = set(workload["limits"]) - set(checks)
    if missing:
        raise RuntimeError(f"the entry compared no {sorted(missing)}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if out["trace"] is not None:
        dev["busy_s"] = tr.busy_s(out["trace"])
        dev["window_s"] = out["trace"].window_s
        result["breakdown"] = tr.breakdown(out["trace"])
    result["checks"] = checks
    return result, lines
