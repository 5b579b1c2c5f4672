"""Tiny stand-ins of the benchmark's configurations for the CPU tests: the
same files with small widths, 128 x 64 clips and a few clips a batch."""
import copy
import time

import torch

from benchmark import harness

SMALL = ["--synthetic_smoke", "--hidden_dim", "32", "--dim_feedforward", "64", "--nheads", "4",
         "--enc_layers", "1", "--dec_layers", "2"]
MODEL = {"hidden_dim": 32, "dim_feedforward": 64, "nheads": 4, "enc_layers": 1, "dec_layers": 2,
         "frames": 128, "n_mels": 64}


def config(name: str, f32: bool = False) -> dict:
    c = copy.deepcopy(harness.load("configs", name))
    flags = list(c["flags"])
    if "--enc_layers" in flags:  # SMALL sets it
        i = flags.index("--enc_layers")
        del flags[i:i + 2]
    i = flags.index("--num_queries")
    flags[i + 1] = "4"
    c["model"].update(MODEL, num_queries=4)
    if c["trainer"] == "self_sup":
        i = flags.index("--num_patches")
        flags[i + 1] = "2"
        c["model"].update(num_patches=2)
    c["flags"] = flags + SMALL + (["--compute_dtype", "float32"] if f32 else [])
    c["train_clips"] = 8
    return c


def traffic(name: str) -> dict:
    t = copy.deepcopy(harness.load("traffic", name))
    t["batch"] = 2
    return t


def workload(name: str) -> dict:
    w = copy.deepcopy(harness.load("workloads", name))
    # float32 against float32 reads about 1e-5 (the ratio: 1e-5 over bf16's 1e-3)
    w["limits"] = {k: 0.1 if k == "grad_median_ratio" else 1e-3 for k in w["limits"]}
    return w


def run(cell: str, traced: bool = False, seed: int = 2 ** 33 + 5, seconds: float = 0.5,
        f32: bool = False):
    w = workload(cell)
    specs = harness.metrics_of(cell, traced, harness.benchmark_file())
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                            workload=w, config=config(w["config"], f32),
                            traffic=traffic(w["traffic"]), specs=specs)
