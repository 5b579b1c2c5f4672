"""Tiny stand-ins of the audio-tag and predict cells for the CPU tests: AST at
2 layers of d 64 over 64 x 96 clips, 12 classes (the port's published
settings patched while a run lasts); the predict cell on the SEDT
configuration of :mod:`benchmark.tests.tiny` over 4 clips in batches of 2.
The program runs in float32, so the limits are round-off's."""
import contextlib
import copy
import time

import torch

from benchmark import harness
from benchmark.tests import tiny
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.models import ASTConfig

AST_SMALL = {"n_mels": 64, "frames": 96, "num_classes": 12, "dim": 64, "heads": 4, "layers": 2,
             "mlp": 128}
TAG, PREDICT = "ast-audioset.tag-b64", "sedt-urbansed.predict-b256"
# float32 against float32 on the CPU: what is left is the order of sums
# (about 1e-6), and Adam's steps on the key bias, whose exact gradient is 0
# (a change of about 5e-4 of the leaf's)
LIMITS = {"out_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 3e-3, "feat_gap": 1e-4}


def tag_config() -> dict:
    c = copy.deepcopy(harness.load("configs", "ast-audioset"))
    c["model"].update(AST_SMALL, tokens=5 * 9 + 2)
    c["flags"] += ["--compute_dtype", "float32"]
    c["train_clips"] = 8
    return c


@contextlib.contextmanager
def small(cell: str):
    """The port's AST at :data:`AST_SMALL` for the audio-tag cell."""
    if cell != TAG:
        yield
        return
    real = train_lib.AUDIOSET
    train_lib.AUDIOSET = ASTConfig(**AST_SMALL)
    try:
        yield
    finally:
        train_lib.AUDIOSET = real


def config(cell: str) -> dict:
    return tag_config() if cell == TAG else tiny.config("sedt-urbansed", f32=True)


def traffic(cell: str) -> dict:
    w = harness.load("workloads", cell)
    t = copy.deepcopy(harness.load("traffic", w["traffic"]))
    t["batch"] = 2
    if cell == PREDICT:
        t["clips"] = 4
    return t


def workload(cell: str) -> dict:
    w = copy.deepcopy(harness.load("workloads", cell))
    w["limits"] = {k: LIMITS[k] for k in w["limits"]}
    return w


def run(cell: str, traced: bool = False, seed: int = 2 ** 33 + 5, seconds: float = 0.5,
        specs=None):
    """One run of ``cell`` at the tiny size: the metrics ``BENCHMARK.json``
    gives the cell, or ``specs``."""
    if specs is None:
        specs = harness.metrics_of(cell, traced, harness.benchmark_file())
    with small(cell):
        return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                                time.perf_counter(), workload=workload(cell), config=config(cell),
                                traffic=traffic(cell), specs=specs)
