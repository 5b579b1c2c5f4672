#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It builds every kernel from the sources in the repository (``csrc/*.cu`` with
nvcc for sm_90a, all started together), then:

1. prints the card's name and power limit and each build's time;
2. holds every kernel against its plain PyTorch version on the card: the
   Hungarian kernels K1, K2 and K3 index for index, and against scipy on the
   host (random, tie-heavy and BIG-padded costs; K2's warp variant at
   nc + 1 = 33, 64, 65, 128 and 256 and its block variant beyond; K3's warp
   variant up to n = 126 and its square variant from 127), the
   flash-attention kernel K4 at the long clip's two shapes in bf16 and f32,
   at a ragged tiny shape and at head dims 64 and 128, with a key-padding
   bias (one clip's keys all padded), a full bias and none; its tensor-core
   variant also at query sides of 1, 16, 17 and 41 rows, at key sides below
   one tile and ragged, with the keys split over blocks, and a bf16 input on
   an 8- but not 16-byte boundary, which must take the f32-core variant;
3. runs the evaluation step at the tiny f32 geometry, the tiny long-clip
   predict (528 encoder tokens, so the card takes K4), two tiny train
   steps (dropout 0 on the training path), ``train_lib.evaluate`` over 48
   clips with its feature bank (on weights whose class scores follow the
   clip, so that F1 and PSDS are not all zero), and the trainer
   ``run_supervised`` at the tiny size (resnet18, d 64, 1+1 layers, batch 4,
   16 clips, 2 epochs, dropout 0, no augmentation, no fine-tune epoch), on
   the CPU and on the card from the same weights, and compares the two (TF32
   off, to 1e-3: the losses, every parameter after each train step, each
   epoch's train and validation loss means; the evaluation's F1 and PSDS
   exactly, every F1 of the trainer to 1e-3); then the same trainer on
   small seeded datasets on disk (URBAN-SED ``.npy``, URBAN-SED
   ``--from_wavs``, DCASE ``.npy`` with a weak stream; 500 and 496 frames),
   card against CPU, each epoch's loss means to 1e-3;
4. drives the flagship URBAN-SED evaluation step (10 s clips, batch 64)
   through ``build_model`` and ``make_eval_step``, with K1's launch count;
4b. drives the flagship supervised train step at batch 64 (``bench_torch``'s
   configuration and synthetic batch; dropout 0.1, bf16 autocast over f32
   parameters) through ``init_train_state`` and ``make_train_step``: K1 must
   launch once per step and K4 never; every loss finite, the trainable
   parameters moved, the frozen ones and every FrozenBN buffer unchanged bit
   for bit; it prints ms/step and clips/s (CUDA events and host clock), the
   peak memory, the device's busy share under the profiler and the step's
   FLOPs (``FlopCounterMode``) as a share of the card's dense bf16 peak; then
   the fine-tune step (``fine_tune``, lr 1e-5: K1 twice a step, at
   [64,10,20] and [128,10,20]) and the augmented step (the DCASE recipe's
   mixup 0.6, frequency mask and shift, and a time mask);
4c. drives the supervised trainer at the flagship's widths through
   ``cli.sedt_args`` and ``train_lib.run_supervised`` (``FLAGSHIP_TRAINER``:
   URBAN-SED ``--synthetic_smoke``, 128 x 64 clips, 512 training clips at
   batch 64, 3 epochs with the fine-tune stage from epoch 2, evaluation every
   epoch over 128 validation clips, fusion strategies 1-3, the final test
   with PSDS and ROC curves, a checkpoint every epoch): every epoch's loss
   finite, the final test of each strategy, the feature bank in use, each
   best checkpoint loading back into the model, the ROC CSVs written, and K1
   launched exactly as the arguments call for (32 times in train steps, 18
   in eval steps) and K2, K3 and K4 never; it prints each epoch's wall time,
   ms/step and clips/s, the evaluation's time in eval steps, host decode,
   metrics and PSDS, and the checkpoint I/O, times K1 on the cost of the
   run's first train step, then runs the trainer once more for one epoch and
   profiles that epoch's train steps into ``chiprun_out/trainer_profile.txt``;
4d. drives the flagship trainer at 500 x 64 on a dataset on disk: it
   writes a seeded URBAN-SED layout with the port's writer (``DISK_CLIPS``:
   512 / 64 / 64 clips of 10 s at 44.1 kHz) and a seeded torchvision-layout
   ``resnet50.pth`` beside it, then runs ``FLAGSHIP_DISK`` (batch 64, 2
   epochs with the fine-tune stage in the second, strategies 1-3, PSDS, a
   checkpoint every epoch) twice from a fresh ``exp_root``: on the ``.npy``
   cache, which the run extracts, and with ``--from_wavs`` (raw waveforms,
   the frontend inside the train step, no train bank).  Each run must load
   the ImageNet backbone leaf for leaf (conv0 keeps its init), launch K1
   exactly 24 times in train steps and 8 in eval steps and K2-K4 never,
   keep every loss finite and write best checkpoints that load back; it
   prints the writing, the feature extraction and the scaler pass, per
   epoch ms/step, clips/s and the data wait per step, the evaluations and
   the checkpoint I/O, the peak memory, the split of one ``--from_wavs``
   batch (read, collate, pin on the host; copy and frontend on the card),
   and one more epoch of each source profiled into
   ``chiprun_out/disk_trainer_{npy,wav}_profile.txt``;
5. drives long-clip ``predict`` at the flagship's full width: ResNet-50 DC5,
   3+3 layers, d 256, 8 heads, FFN 2048, 60 s clips (2,646,000 samples, 3000
   frames, 752 encoder tokens), 40 queries plus the ``dec_at`` query, batch 8,
   bf16 autocast, seeded waveforms and weights, through ``make_infer`` and
   ``decode_strong``: K4 must launch 6 times per forward, every time its
   tensor-core variant;
6. drives the long-clip evaluation step (24 problems of 40 x 60 per step):
   K2 must launch once per step, its warp variant, and K4 six times; the
   step's own cost is
   solved again by scipy, and by K3 through ``lsap_square`` on the
   square-padded copy, which must take K3's warp variant;
7. times every kernel at the path's shape (device time: CUDA events around a
   replayed CUDA graph of 20 launches; and per call launched from Python) and
   its plain version, computes its bound from bytes and operations, prints a
   second figure beside it on a line of its own (K1-K3: a model of the
   longest search's dependent steps, counted by hand from the source and
   priced at step latencies timed on the card, with the cycles an expansion
   really took; K4: its exponentials at an assumed special-function rate),
   times K1 also at every shape of ``K1_SHAPES`` on seeded costs, and for K4
   times the library call ``F.scaled_dot_product_attention``;
8. profiles the 10 s evaluation step, the train step, a trainer epoch and
   the long predict into ``chiprun_out/``.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA device.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import flagship_config, synthetic_batch
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.cli import sedt_args
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.data.dataset import batch_iterator, collate
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.feature_bank import FeatureBank
from sound_event_detection_transformer_tpu_torch.data.scaler import Scaler
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset
from sound_event_detection_transformer_tpu_torch.engine import (
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import (
    build_model,
    postprocess,
    set_criterion,
    total_loss,
)
from sound_event_detection_transformer_tpu_torch.models.torch_import import (
    torchvision_resnet_shapes,
    torchvision_to_backbone,
)
from sound_event_detection_transformer_tpu_torch.ops import (
    _build,
    attention,
    flash_attention,
    hungarian,
    matcher,
)
from sound_event_detection_transformer_tpu_torch.ops.frontend import make_frontend_fn
from sound_event_detection_transformer_tpu_torch.predict_cli import make_infer
from sound_event_detection_transformer_tpu_torch.utils.checkpoint import load_checkpoint

# One H100 SXM at its 700 W limit (NVIDIA data sheet): device memory rate, the
# f32 rate outside the tensor cores (the type the Hungarian kernels compute
# in) and the tensor cores' dense bf16 rate (the type K4's inputs have).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations per live column in one Dijkstra expansion of a JV kernel: two
# subtractions, a compare and two selects to relax, a compare-select for the
# minimum, two updates of the potentials.
JV_OPS_PER_COLUMN = 8
# Exponentials an SM's special-function units finish per clock (4 units in
# each of its 4 partitions): the assumption behind K4's tighter figure.
EXP_PER_CLOCK_PER_SM = 16
# A model, not a bound: the dependent steps of one Dijkstra expansion of
# ``jv_warp_kernel<C>``, the one body that K1 (C = 1) and the warp variants of
# K2 and K3 (C = 2, 4, 8) share, counted by hand from its source as it stands
# (shared-memory reads, integer warp minima, f32-pipe instructions that must
# follow one another before the next expansion can start; the work once per
# inserted row is left out).  Nothing ties the counts to the source: recount
# after an edit there.  The measured figure beside it is the cycles an
# expansion took, from the kernel's device time, the work per row included.
#   u[i0] and the cost entry read side by side, two subtractions, compare,
#   select, clamp and the live select, the lane's fold (two a column after
#   the first), three for the ordered key, a warp minimum, compare and
#   select, a second warp minimum, unpack and address.
def jv_chain_steps(c: int) -> dict:
    return {"shared_read": 1, "shuffle": 0, "warp_min": 2, "f32_add": 11 + 2 * c}


K1_SHAPES = [(192, 10, 20), (192, 20, 20), (1200, 20, 20)]
WIDE_SHAPES = [(24, 40, 60), (192, 10, 20), (8, 100, 100)]  # K2 and K3
K3_EDGE_SHAPES = [(1, 126, 126), (1, 127, 127)]  # K3's warp variant, then its square one
K2_WARP_SHAPES = [(6, 20, 32), (6, 30, 63), (6, 30, 64), (4, 50, 127), (3, 40, 255)]
K2_BLOCK_SHAPES = [(2, 60, 256), (2, 120, 300)]  # nc + 1 = 257 and beyond
K1_COST_KINDS = ("random", "ties", "big")
K3_PLAIN_PROBLEMS = 4  # K3's plain version solves one problem at a time: a few per batch
SECONDS = 10.0
LONG_SECONDS = 60.0
LONG_BATCH = 8
FUSION = (1, 2, 3)
STEPS = 10  # timed 10 s evaluation steps
TRAIN_WARMUP = 3  # flagship train steps before the timed ones
TRAIN_STEPS = 10  # timed flagship train steps
FINE_TUNE_STEPS = 3
AUGMENT_STEPS = 2
LONG_STEPS = 5  # timed long-clip evaluation steps
LONG_FORWARDS = 3  # timed long-clip predict batches
SEED = 0
# the trainers: the tiny one on the card against the CPU, and the flagship's
# widths on --synthetic_smoke's 128 x 64 clips (8 steps an epoch, 2 plain
# epochs and 1 fine-tune epoch, 128 validation clips in 2 batches)
TRAIN_ROOT = "build/chip_train"
TINY_TRAINER = ["--dataname", "urbansed", "--synthetic_smoke", "--smoke_clips", "16",
                "--batch_size", "4", "--backbone", "resnet18", "--hidden_dim", "64",
                "--enc_layers", "1", "--dec_layers", "1", "--dim_feedforward", "128",
                "--epochs", "2", "--epochs_ls", "10", "--dropout", "0", "--compute_dtype",
                "float32", "--dec_at", "--fusion_strategy", "1", "2", "3", "--log",
                "--info", "tiny"]
FLAGSHIP_TRAINER = ["--dataname", "urbansed", "--synthetic_smoke", "--smoke_clips", "512",
                    "--batch_size", "64", "--dec_at", "--epochs", "3", "--epochs_ls", "2",
                    "--eval_interval", "1", "--fusion_strategy", "1", "2", "3", "--psds",
                    "--roc_curves", TRAIN_ROOT + "/roc/", "--checkpoint_epochs", "1",
                    "--exp_root", TRAIN_ROOT, "--log"]  # --log: stdout is not teed to ./log
# the trainer on disk: the flagship at 500 x 64 on a seeded URBAN-SED layout
# (512 / 64 / 64 clips, cut from the real 6,000 / 2,000 / 2,000), 8 steps an
# epoch, a plain and a fine-tune epoch, one batch per validation and eval;
# and the tiny trainer on a few clips in both layouts, card against CPU
DISK_ROOT = "build/chip_data"
DISK_EXP = "build/chip_disk_exp"
DISK_CLIPS = {"train": 512, "validate": 64, "test": 64}
FLAGSHIP_DISK = ["--dataname", "urbansed", "--data_root", DISK_ROOT, "--batch_size", "64",
                 "--dec_at", "--epochs", "2", "--epochs_ls", "1", "--eval_interval", "1",
                 "--fusion_strategy", "1", "2", "3", "--psds", "--checkpoint_epochs", "1",
                 "--log"]
TINY_DISK_ROOT = "build/chip_data_tiny"
TINY_DISK = ["--data_root", TINY_DISK_ROOT, "--batch_size", "4", "--backbone", "resnet18",
             "--hidden_dim", "64", "--enc_layers", "1", "--dec_layers", "1",
             "--dim_feedforward", "128", "--epochs", "2", "--epochs_ls", "10", "--dropout", "0",
             "--compute_dtype", "float32", "--dec_at", "--fusion_strategy", "1", "2", "--log",
             "--info", "tiny"]
SOURCE_DIR = "sound_event_detection_transformer_tpu_torch/csrc/"
PALLAS_DIR = "sound_event_detection_transformer_tpu/ops/pallas/"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi states it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def latency_probe(dev: torch.device) -> dict:
    """Cycles of one dependent step of each kind that a JV search is a chain
    of, timed on the card by one warp over a few thousand steps (the tool of
    ``csrc/latency_probe.cu``): a shared-memory read, an f32 add, a shuffle and
    an integer warp minimum."""
    lib = _build.load_library("latency_probe")
    lib.sedt_latency_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sedt_latency_probe.restype = ctypes.c_int
    out = torch.zeros(6, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.sedt_latency_probe(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sedt_latency_probe launch failed: cudaError {err}")
    cycles = out.cpu().tolist()
    names = ("shared_read", "f32_add", "shuffle", "warp_min")
    return {name: cycles[i] / cycles[4] for i, name in enumerate(names)}


def build_kernels() -> dict:
    """Start every source's nvcc build together; returns each build's seconds
    and the wall seconds of all under ``"all"``."""
    def timed(name):
        t0 = time.perf_counter()
        _build.build_library(name, verbose=True)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        futures = {name: pool.submit(timed, name) for name in _build.SOURCES}
        seconds = {name: fut.result() for name, fut in futures.items()}
    seconds["all"] = time.perf_counter() - t0
    return seconds


def reset_launch_counts() -> None:
    for wrapper in (hungarian.lsap_lane, hungarian.lsap_block, hungarian.lsap_square,
                    flash_attention.flash_attention):
        for name in vars(wrapper):
            if name.startswith("launches"):
                setattr(wrapper, name, 0)


def launch_counts() -> dict:
    """Every wrapper's count, and under ``"K2 warp"``, ``"K4 tensor"`` and so
    on the counts of the variants that K2, K3 and K4 dispatch between."""
    k2, k3, k4 = hungarian.lsap_block, hungarian.lsap_square, flash_attention.flash_attention
    return {"K1": hungarian.lsap_lane.launches, "K2": k2.launches,
            "K3": k3.launches, "K4": k4.launches,
            "K2 warp": k2.launches_warp, "K2 block": k2.launches_block,
            "K3 warp": k3.launches_warp, "K3 square": k3.launches_square,
            "K4 tensor": k4.launches_tensor, "K4 f32": k4.launches_f32,
            "K4 split": k4.launches_split}


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


# ------------------------------------------------- K1, K2, K3: assignment


def k1_costs(rng: np.random.RandomState, shape, kind: str) -> np.ndarray:
    if kind == "random":
        return (rng.randn(*shape) * rng.uniform(0.1, 10)).astype(np.float32)
    if kind == "ties":  # small integers: many optimal assignments
        return rng.randint(0, 3, shape).astype(np.float32)
    costs = rng.randn(*shape).astype(np.float32)  # BIG-padded target slots
    costs[:, :, rng.randint(0, shape[2] + 1):] = matcher.BIG
    return costs


def assignment_cost(costs: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Per-problem cost of a row-for-column assignment, after checking that
    every row is used once and exactly the nc - nr free columns hold -1."""
    b, nr, nc = costs.shape
    assert out.shape == (b, nc), out.shape
    total = np.zeros(b)
    for i in range(b):
        cols = np.nonzero(out[i] >= 0)[0]
        rows = out[i][cols]
        assert sorted(rows.tolist()) == list(range(nr)), (i, out[i])
        assert len(cols) == nr and (out[i] == -1).sum() == nc - nr, (i, out[i])
        total[i] = costs[i][rows, cols].astype(np.float64).sum()
    return total


def scipy_optimum(costs: np.ndarray) -> np.ndarray:
    return np.array([costs[i][linear_sum_assignment(costs[i])].astype(np.float64).sum()
                     for i in range(costs.shape[0])])


def lsap_against_references(kernel, plain, costs: np.ndarray, dev: torch.device,
                            label: str) -> float:
    """A rectangular JV kernel against its plain version, index for index
    (the same arithmetic and tie-break), and against scipy on one batch of
    problems; returns the largest |cost(kernel) - optimum|.  Raises past
    1e-2 * max(1, |optimum|): scipy may break ties otherwise, never at
    another cost."""
    cost_dev = torch.from_numpy(costs).to(dev)
    got = kernel(cost_dev).cpu().numpy()
    got_plain = plain(cost_dev).cpu().numpy()
    if not np.array_equal(got, got_plain):
        raise AssertionError(f"{label}: kernel and plain version differ in "
                             f"{int((got != got_plain).any(axis=1).sum())} problems")
    best = scipy_optimum(costs)
    tol = 1e-2 * np.maximum(1.0, np.abs(best))
    err = np.abs(assignment_cost(costs, got) - best)
    if not (err <= tol).all():
        raise AssertionError(f"parity failed at {label}: |cost - optimum| {err.max()}")
    return float(err.max())


def k1_against_references(costs: np.ndarray, dev: torch.device, label: str) -> float:
    return lsap_against_references(hungarian.lsap_lane, hungarian.lsap_plain, costs, dev,
                                   "K1 " + label)


def took_variant(name: str, want: str, call, label: str):
    """``call()``, which must count one launch of kernel ``name``, of its
    variant ``want``; returns what ``call`` returns."""
    before = launch_counts()
    out = call()
    after = launch_counts()
    took = {k: after[k] - before[k] for k in after if k.split()[0] == name}
    assert took[name] == took[f"{name} {want}"] == 1, f"{name} at {label} should take {want}: {took}"
    return out


def k2_against_references(costs: np.ndarray, dev: torch.device, label: str) -> float:
    """K2 against its plain version (index for index) and scipy; the launch
    must count into the variant that ``block_variant`` names."""
    return took_variant("K2", hungarian.block_variant(*costs.shape[1:]),
                        lambda: lsap_against_references(hungarian.lsap_block,
                                                        hungarian.lsap_plain, costs, dev,
                                                        "K2 " + label), label)


def k3_against_references(costs: np.ndarray, dev: torch.device, label: str) -> float:
    """K3 on the square-padded copy of rectangular costs against its plain
    version (a few problems, index for index) and scipy; the launch must
    count into the variant that ``square_variant`` names.  The padding rows
    cost BIG in every column, so the optimum over the real rows is the
    rectangle's; compared on the real rows, to the same
    1e-2 * max(1, |optimum|)."""
    b, nr, nc = costs.shape
    square = matcher._square_pad(torch.from_numpy(costs).to(dev))
    got = took_variant("K3", hungarian.square_variant(nc),
                       lambda: hungarian.lsap_square(square).cpu().numpy(), label)
    n_plain = min(K3_PLAIN_PROBLEMS, b)
    got_plain = hungarian.lsap_square_plain(square[:n_plain]).cpu().numpy()
    if not np.array_equal(got[:n_plain], got_plain):
        raise AssertionError(f"K3 at {label}: kernel and plain version differ")
    best = scipy_optimum(costs)
    tol = 1e-2 * np.maximum(1.0, np.abs(best))
    real = lambda out: np.where(out < nr, out, -1).astype(np.int32)  # drop the padding rows
    err = np.abs(assignment_cost(costs, real(got)) - best)
    if not (err <= tol).all():
        raise AssertionError(f"K3 parity failed at {label}: |cost - optimum| {err.max()}")
    return float(err.max())


def jv_expansions(costs: np.ndarray) -> int:
    """Dijkstra expansions that JV makes on these problems: the data-dependent
    part of a JV kernel's work (the same insertion order and tie-break)."""
    return sum(jv_expansions_each(costs))


def jv_expansions_each(costs: np.ndarray) -> list:
    """The expansions of each problem of the batch."""
    each = []
    for a in costs.astype(np.float32):
        total = 0
        nr, nc = a.shape
        u = np.zeros(nr + 1, np.float32)
        v = np.zeros(nc + 1, np.float32)
        p = np.zeros(nc + 1, np.int64)
        for i in range(1, nr + 1):
            p[0] = i
            j0 = 0
            minv = np.full(nc + 1, np.inf, np.float32)
            used = np.zeros(nc + 1, bool)
            way = np.zeros(nc + 1, np.int64)
            while True:
                total += 1
                used[j0] = True
                i0 = p[j0]
                live = ~used
                live[0] = False
                cur = np.zeros(nc + 1, np.float32)
                cur[1:] = a[i0 - 1] - u[i0] - v[1:]
                better = live & (cur < minv)
                minv[better] = cur[better]
                way[better] = j0
                j1 = int(np.argmin(np.where(live, minv, np.inf)))
                delta = minv[j1]
                u[p[used]] += delta
                v[used] -= delta
                minv[~used] -= delta
                j0 = j1
                if p[j0] == 0:
                    break
            while j0:
                j1 = way[j0]
                p[j0] = p[j1]
                j0 = j1
        each.append(total)
    return each


def jv_bound(cost: torch.Tensor) -> dict:
    """The least time a JV kernel could take on ``cost``: the bytes it must
    move (the cost read once, the int32 answer written once) over the memory
    rate, against its f32 operations on these costs over the f32 rate; also
    the expansions of the longest search."""
    b, nr, nc = cost.shape
    nbytes = cost.numel() * 4 + b * nc * 4
    each = jv_expansions_each(cost.cpu().numpy())
    expansions = sum(each)
    ops = expansions * (nc + 1) * JV_OPS_PER_COLUMN
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"ms": max(bytes_ms, ops_ms), "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "expansions": expansions, "ops": ops,
            "ops_ms": ops_ms, "longest": max(each)}


def warp_columns(name: str, nc: int) -> int:
    """C, the columns a lane of ``jv_warp_kernel<C>`` when kernel ``name``
    runs it on nc columns: 1 for K1, else the least of 2, 4 and 8 that holds
    the virtual root and the columns (``sedt_jv_warp``)."""
    return 1 if name == "K1" else next(c for c in (2, 4, 8) if 32 * c >= nc + 1)


def jv_chain(name: str, nc: int, longest: int, latency: dict, clock_hz: float) -> dict:
    """A model of the warp kernel's time (hand counts, so no bound): the
    longest search of the batch (``longest`` expansions of one problem;
    problems run side by side) times the cycles of one expansion's dependent
    steps, ``jv_chain_steps`` at the step latencies the probe timed on this
    card, over the SM clock."""
    steps = jv_chain_steps(warp_columns(name, nc))
    cycles = sum(n * latency[kind] for kind, n in steps.items())
    return {"ms": longest * cycles / clock_hz * 1e3, "longest": longest, "cycles": cycles,
            "steps": steps}


def time_jv(name: str, kernel, plain, cost: torch.Tensor, card: str, plain_iters: int,
            latency: dict, clock_hz: float, plain_warmup: int = 1) -> dict:
    ms = device_ms(lambda: kernel(cost))
    eager_ms = cuda_ms(lambda: kernel(cost), 100)
    plain_ms = cuda_ms(lambda: plain(cost), plain_iters, warmup=plain_warmup)
    bound = jv_bound(cost)
    chain = jv_chain(name, cost.shape[2], bound["longest"], latency, clock_hz)
    print(f"{name} {list(cost.shape)}: {ms:.5f} ms on the device ({eager_ms:.5f} ms per call "
          f"launched back to back from Python), plain version {plain_ms:.3f} ms, "
          f"bound {bound['ms']:.7f} ms by {bound['by']} ({card})")
    print(f"{name} bound: {bound['bytes']} B in {bound['bytes_ms']:.7f} ms; "
          f"{bound['expansions']} expansions, {bound['ops']} f32 operations in "
          f"{bound['ops_ms']:.7f} ms")
    print(f"{name} chain model (hand-counted steps, not a bound): {chain['ms']:.5f} ms = "
          f"{chain['longest']} expansions in the longest search x {chain['cycles']:.1f} cycles of dependent steps {chain['steps']} "
          f"at {clock_hz / 1e6:.0f} MHz; the kernel takes "
          f"{ms * 1e-3 * clock_hz / chain['longest']:.1f} cycles an expansion of that search "
          f"({card})")
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["by"],
            "library_ms": None}  # no PyTorch call computes a linear sum assignment


def seeded_k1_cost(shape, kind: str, dev) -> torch.Tensor:
    """The costs K1 is timed on away from the eval step, the same in every
    checkout of the port (``tools/time_jv_kernels.py`` times them too)."""
    return torch.from_numpy(k1_costs(np.random.RandomState(SEED), shape, kind)).to(dev)


def time_k1_shapes(dev, card: str, clock_hz: float) -> None:
    """K1's device time at every shape of ``K1_SHAPES`` on seeded BIG-padded
    costs (as the matcher's are: a clip's events fill some target slots, the
    rest cost BIG), with its bound and the cycles an expansion of the longest
    search took."""
    for shape in K1_SHAPES:
        cost = seeded_k1_cost(shape, "big", dev)
        ms = device_ms(lambda: hungarian.lsap_lane(cost))
        bound = jv_bound(cost)
        longest = bound["longest"]
        print(f"K1 {list(shape)} on seeded BIG-padded costs: {ms:.5f} ms on the device, "
              f"bound {bound['ms']:.7f} ms by {bound['by']}; {longest} expansions in the "
              f"longest search, {ms * 1e-3 * clock_hz / longest:.1f} cycles an expansion "
              f"({card})")


# ------------------------------------------------------ K4: flash attention


def attention_inputs(rng, b, h, sq, sk, d, dtype, dev, bias_kind: str, projected: bool = False,
                     shifted: bool = False):
    """Seeded q, k, v and a bias.  ``projected`` lays q, k, v out as the
    model's projections do: [B, S, H, D] in memory, seen as [B, H, S, D].
    ``shifted`` cuts them out of wider rows 4 elements in, so that bf16 data
    starts on an 8- but not a 16-byte boundary."""
    def draw(s):
        x = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)).to(dev, dtype)
        if shifted:
            wide = torch.zeros(b, s, h * d + 8, dtype=dtype, device=dev)
            wide[..., 4:4 + h * d] = x.reshape(b, s, h * d)
            return wide[..., 4:4 + h * d].unflatten(-1, (h, d)).transpose(1, 2)
        return x.transpose(1, 2) if projected else x.transpose(1, 2).contiguous()

    q, k, v = draw(sq), draw(sk), draw(sk)
    if bias_kind == "none":
        bias = None
    elif bias_kind == "full":
        bias = torch.from_numpy(rng.randn(b, h, sq, sk).astype(np.float32)).to(dev)
    else:  # key padding: clip 0 all padded, the others a random tail
        pad = np.arange(sk)[None, :] >= rng.randint(sk // 2, sk + 1, size=(b, 1))
        pad[0] = True
        bias = attention.make_key_padding_bias(torch.from_numpy(pad).to(dev))
    return q, k, v, bias


def k4_against_plain(q, k, v, bias, label: str, variant: str | None = None,
                     split: bool | None = None) -> float:
    """K4 against its plain blockwise version on the same tensors; returns
    max |difference|.  f32 inputs: 1e-5 (both keep f32 state and differ in the
    order of the sums only).  bf16 inputs: both round an f32 result to bf16
    once, so they differ by one bf16 rounding at most, 1e-2 relative.  Against
    the non-flash path, which rounds the probabilities to bf16 before the
    second product: bf16-level, 3e-2.  ``variant`` ("tensor" or "f32") and
    ``split`` say which kernel must have counted the launch, and whether it
    must have split the keys."""
    before = launch_counts()
    got = flash_attention.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    after = launch_counts()
    took = {key: after[key] - before[key] for key in after if key.startswith("K4")}
    assert took["K4"] == 1 and took["K4 tensor"] + took["K4 f32"] == 1, (label, took)
    if variant is not None:
        assert took[f"K4 {variant}"] == 1, f"K4 at {label} should take the {variant} variant: {took}"
    if split is not None:
        assert took["K4 split"] == int(split), f"K4 at {label}: split {took}, wanted {split}"
    assert got.shape == q.shape and got.dtype == q.dtype and torch.isfinite(got).all().item()
    plain = flash_attention.flash_attention_plain(q, k, v, bias)
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    err = float((got.float() - plain.float()).abs().max())
    if not torch.allclose(got.float(), plain.float(), rtol=tol, atol=tol):
        raise AssertionError(f"K4 parity failed at {label}: max |kernel - plain| {err}")
    ref = flash_attention.reference_attention(q, k, v, bias)
    loose = 1e-4 if q.dtype == torch.float32 else 3e-2
    if not torch.allclose(got.float(), ref.float(), rtol=loose, atol=loose):
        raise AssertionError(f"K4 against the non-flash path failed at {label}: "
                             f"{float((got.float() - ref.float()).abs().max())}")
    return err


def k4_bound(q, k, bias) -> dict:
    """The least time K4 could take: q, k, v, the output and the bias as
    stored, moved once, against the two products' operations at the peak rate
    of the inputs' type (bf16: tensor cores; f32: the f32 cores)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if bias is not None:
        nbytes += bias.numel() * 4
    ops = 4 * b * h * sq * sk * d
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"ms": max(bytes_ms, ops_ms), "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms}


def time_k4(rng, sq: int, sk: int, dev, card: str, clock_hz: float) -> dict:
    """K4, its plain version and the library call at one of the long clip's
    shapes, on bf16 tensors laid out as the model's projections lay them."""
    q, k, v, bias = attention_inputs(rng, LONG_BATCH, 8, sq, sk, 32, torch.bfloat16, dev,
                                     "padding", projected=True)
    before = launch_counts()
    ms = device_ms(lambda: flash_attention.flash_attention(q, k, v, bias))
    after = launch_counts()
    assert after["K4 tensor"] - before["K4 tensor"] == after["K4"] - before["K4"] > 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = flash_attention.rows_per_block(sq)
    splits = flash_attention.key_splits(LONG_BATCH * 8 * -(-sq // rows), sk, sms)
    exp_ms = q.shape[0] * q.shape[1] * sq * sk / (EXP_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3
    print(f"K4 q [{LONG_BATCH},8,{sq},32]: tensor-core variant, {rows} rows a block, "
          f"{splits[0]} key range(s) of {splits[1]}; its {q.shape[0] * q.shape[1] * sq * sk} "
          f"exponentials alone take {exp_ms:.5f} ms at {EXP_PER_CLOCK_PER_SM} a clock on each "
          f"of {sms} SMs at {clock_hz / 1e6:.0f} MHz (assumed rate) ({card})")
    eager_ms = cuda_ms(lambda: flash_attention.flash_attention(q, k, v, bias), 50)
    plain_ms = cuda_ms(lambda: flash_attention.flash_attention_plain(q, k, v, bias), 5, warmup=1)
    mask = bias.to(q.dtype)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    bound = k4_bound(q, k, bias)
    print(f"K4 q {list(q.shape)} k {list(k.shape)} bf16: {ms:.5f} ms on the device "
          f"({eager_ms:.5f} ms per call launched back to back from Python), plain version "
          f"{plain_ms:.3f} ms, library call {library_ms:.5f} ms on the device, bound "
          f"{bound['ms']:.6f} ms "
          f"by {bound['by']} ({bound['bytes']} B in {bound['bytes_ms']:.6f} ms; {bound['ops']} "
          f"operations in {bound['ops_ms']:.6f} ms) ({card})")
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["by"], "library_ms": library_ms}


def check_kernels(dev: torch.device) -> dict:
    """Phase 2: every kernel against its references; returns the largest
    error of each (assignment cost against the optimum; K4 against its plain
    version, bf16 cases and f32 cases apart)."""
    rng = np.random.RandomState(SEED)
    errs = collections.defaultdict(float)
    for shape in K1_SHAPES:
        for kind in K1_COST_KINDS:
            err = k1_against_references(k1_costs(rng, shape, kind), dev, f"{shape} {kind}")
            errs["K1"] = max(errs["K1"], err)
            print(f"K1 parity {list(shape)} {kind}: ok, max |cost - optimum| {err:.3g}")
    for shape in WIDE_SHAPES:
        for kind in K1_COST_KINDS:
            costs = k1_costs(rng, shape, kind)
            e2 = k2_against_references(costs, dev, f"{shape} {kind}")
            e3 = k3_against_references(costs, dev, f"{shape} {kind}")
            errs["K2"], errs["K3"] = max(errs["K2"], e2), max(errs["K3"], e3)
            print(f"K2 and K3 parity {list(shape)} {kind}: ok, max |cost - optimum| "
                  f"{e2:.3g} and {e3:.3g}")
    for shape in K3_EDGE_SHAPES:  # K3's two variants at their edge
        for kind in K1_COST_KINDS:
            errs["K3"] = max(errs["K3"], k3_against_references(k1_costs(rng, shape, kind), dev,
                                                               f"{shape} {kind}"))
        print(f"K3 parity {list(shape)} ({hungarian.square_variant(shape[2])} variant): ok on "
              f"{', '.join(K1_COST_KINDS)} costs")
    # K2's two variants at their edges: the warp variant with 2, 4 and 8 columns
    # a lane up to nc + 1 = 256, the block variant from 257
    for variant, shapes in (("warp", K2_WARP_SHAPES), ("block", K2_BLOCK_SHAPES)):
        for shape in shapes:
            assert hungarian.block_variant(*shape[1:]) == variant, shape
            for kind in K1_COST_KINDS:
                e2 = k2_against_references(k1_costs(rng, shape, kind), dev, f"{shape} {kind}")
                errs["K2"] = max(errs["K2"], e2)
            print(f"K2 parity {list(shape)} ({variant} variant, nc + 1 = {shape[2] + 1}): ok "
                  f"on {', '.join(K1_COST_KINDS)} costs")
    # K4: (B, H, Sq, Sk, D); the long clip's encoder and cross shapes, a ragged
    # tiny one, and the two wide head dims
    shapes = [(LONG_BATCH, 8, 752, 752, 32), (LONG_BATCH, 8, 41, 752, 32), (2, 4, 40, 528, 16),
              (2, 2, 70, 130, 64), (1, 2, 33, 200, 128)]
    for i, (b, h, sq, sk, d) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            for bias_kind in ("padding", "full", "none"):
                q, k, v, bias = attention_inputs(rng, b, h, sq, sk, d, dtype, dev, bias_kind,
                                                 projected=bias_kind == "padding")
                name = str(dtype).split(".")[1]
                variant = "tensor" if dtype == torch.bfloat16 and d != 16 else "f32"
                err = k4_against_plain(q, k, v, bias, f"{shapes[i]} {name} {bias_kind}", variant)
                errs[f"K4 {name}"] = max(errs[f"K4 {name}"], err)
                if i < 2 and dtype == torch.bfloat16:
                    errs[f"K4 {sq}"] = max(errs[f"K4 {sq}"], err)
                print(f"K4 parity q[{b},{h},{sq},{d}] k[{b},{h},{sk},{d}] {name} bias "
                      f"{bias_kind}: ok, max |kernel - plain| {err:.3g}")
    # the tensor-core variant at its edges: one query row, a whole warp, one
    # row more, the cross side at D 128; fewer keys than a tile, ragged key
    # sides; few enough blocks that the keys are split (clip 0 of a padding
    # bias has every key padded, so all its ranges are masked, and the other
    # clips' padded tails mask whole ranges)
    edges = [(2, 2, 1, 752, 32, True), (2, 2, 16, 40, 32, False), (2, 2, 17, 100, 64, True),
             (1, 2, 41, 200, 128, True), (2, 4, 41, 130, 64, True), (3, 2, 16, 65, 32, True)]
    for b, h, sq, sk, d, split in edges:
        for bias_kind in ("padding", "full", "none"):
            q, k, v, bias = attention_inputs(rng, b, h, sq, sk, d, torch.bfloat16, dev, bias_kind,
                                             projected=bias_kind == "padding")
            err = k4_against_plain(q, k, v, bias, f"{(b, h, sq, sk, d)} bf16 {bias_kind}",
                                   "tensor", split)
            errs["K4 bfloat16"] = max(errs["K4 bfloat16"], err)
        print(f"K4 parity q[{b},{h},{sq},{d}] k[{b},{h},{sk},{d}] bf16, tensor-core variant, "
              f"keys {'split' if split else 'in one range'}: ok with every bias kind")
    assert k4_split_of_main_shapes(dev) == {752: False, 41: True}
    # bf16 on an 8- but not 16-byte boundary: the f32-core variant takes it, and says so
    for bias_kind in ("padding", "none"):
        q, k, v, bias = attention_inputs(rng, 2, 4, 41, 200, 32, torch.bfloat16, dev, bias_kind,
                                         shifted=True)
        assert q.data_ptr() % 16 == 8 and k.data_ptr() % 16 == 8 and v.data_ptr() % 16 == 8
        err = k4_against_plain(q, k, v, bias, f"shifted bf16 {bias_kind}", "f32", False)
        errs["K4 bfloat16"] = max(errs["K4 bfloat16"], err)
    print("K4 parity bf16 input 8 bytes off a 16-byte boundary: ok, took the f32-core variant")
    torch.cuda.synchronize()
    return errs


def k4_split_of_main_shapes(dev) -> dict:
    """Whether the wrapper splits the keys at the long clip's two shapes on
    this card: {query rows: split or not}."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for sq in (752, 41):
        blocks = LONG_BATCH * 8 * -(-sq // flash_attention.rows_per_block(sq))
        out[sq] = flash_attention.key_splits(blocks, 752, sms)[0] > 1
    return out


# ------------------------------------------------------------ evaluation


def make_batches(cfg: SEDTConfig, batch: int, n_batches: int, seed: int,
                 seconds: float = SECONDS, clip_events: int = 5):
    m = cfg.model
    enc = BoxEncoder(cfg.data.classes, seconds)
    ds = SyntheticDataset(batch * n_batches, cfg.data.classes, m.max_frames, m.n_mels,
                          enc.encode_strong_df, max_events=clip_events, seconds=seconds, seed=seed)
    batches = [collate([ds[i] for i in range(k * batch, (k + 1) * batch)], m.max_events,
                       seconds, indexes=range(k * batch, (k + 1) * batch))
               for k in range(n_batches)]
    return enc, batches


def check_eval_result(res: dict, wd: dict, cfg: SEDTConfig, batch: int) -> None:
    """Finite values of the expected shapes, and the weight dict's losses: every
    final-layer loss, and the aux layers' set losses (the weight dict also
    names aux copies of the audio-tag losses, which no layer computes)."""
    m = cfg.model
    losses = res["losses"]
    weighted = {k for k in wd if not k[-1].isdigit()} | {
        f"{k}_{i}" for k in ("loss_ce", "loss_bbox", "loss_giou") for i in range(m.dec_layers - 1)}
    logged = {"class_error", "cardinality_error"} | {
        f"cardinality_error_{i}" for i in range(m.dec_layers - 1)}
    assert weighted <= set(wd) and set(losses) == weighted | logged, sorted(losses)
    for k, v in losses.items():
        assert v.dim() == 0 and torch.isfinite(v).item(), (k, v)
    assert torch.isfinite(total_loss(losses, wd)).item()
    if m.dec_at:
        at = res["at"]
        assert at.shape == (batch, m.num_classes) and ((at >= 0) & (at <= 1)).all().item()
    for at_m in FUSION:
        check_predictions(*res[f"pp_{at_m}"], cfg, batch)


def check_predictions(scores, labels, boxes, cfg: SEDTConfig, batch: int) -> None:
    m = cfg.model
    assert scores.shape == (batch, m.num_queries) and torch.isfinite(scores).all().item()
    assert ((labels >= 0) & (labels < m.num_classes)).all().item()
    assert boxes.shape == (batch, m.num_queries, 2) and torch.isfinite(boxes).all().item()


class cudnn_tf32_off:
    """f32 convolutions in full f32 while a card result is held against the CPU."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.saved


def small_reference(dev: torch.device, seed: int) -> float:
    """The tiny f32 evaluation step on the card against the same step on the
    CPU (where K1 is its plain version); returns the largest loss difference."""
    cfg = SEDTConfig.tiny_test()
    _, batches = make_batches(cfg, 4, 1, seed)
    valid = torch.tensor([True, True, True, False])
    res = {}
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, wd = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
            res[d.type] = make_eval_step(model, wd, cfg, FUSION, device=d)(batches[0], valid)
    ref, got = res["cpu"], res["cuda"]
    check_eval_result(got, wd, cfg, 4)
    worst = 0.0
    for k, r in ref["losses"].items():
        g = got["losses"][k].cpu()
        assert torch.allclose(g, r, rtol=1e-3, atol=1e-3), (k, g, r)
        worst = max(worst, float((g - r).abs()))
    for at_m in FUSION:
        for g, r in zip(got[f"pp_{at_m}"], ref[f"pp_{at_m}"]):
            assert torch.allclose(g.cpu().float(), r.float(), rtol=1e-3, atol=1e-3), at_m
    return worst


def tiny_train_config() -> SEDTConfig:
    """The tiny f32 config with dropout 0, so that the training path's
    random draws decide nothing and two devices can be compared."""
    cfg = SEDTConfig.tiny_test()
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))


def small_train_step(dev: torch.device, seed: int, steps: int = 2) -> float:
    """Two tiny f32 train steps on the card against the same steps on the
    CPU (where K1 is its plain version), from the same weights and batch,
    TF32 off: the losses and every parameter after each step to 1e-3.
    Returns the largest difference."""
    cfg = tiny_train_config()
    _, batches = make_batches(cfg, 4, 1, seed)
    runs = {}
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, wd = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
            state = init_train_state(model, cfg, steps_per_epoch=10)
            step = make_train_step(model, wd, cfg, state.optimizer, device=d)
            gen = torch.Generator(device=d).manual_seed(seed)
            runs[d.type] = []
            for _ in range(steps):
                metrics = step(batches[0], gen)
                runs[d.type].append(({k: v.cpu() for k, v in metrics.items()},
                                     {k: v.cpu().clone() for k, v in model.state_dict().items()}))
    worst = 0.0
    for (ref_m, ref_p), (got_m, got_p) in zip(runs["cpu"], runs["cuda"]):
        for k, r in ref_m.items():
            assert torch.isfinite(got_m[k]).item() and torch.allclose(got_m[k], r, rtol=1e-3,
                                                                      atol=1e-3), (k, got_m[k], r)
            worst = max(worst, float((got_m[k] - r).abs()))
        for k, r in ref_p.items():
            assert torch.allclose(got_p[k], r, rtol=1e-3, atol=1e-3), k
            worst = max(worst, float((got_p[k] - r).abs().max()))
    return worst


def clip_following_weights(cfg: SEDTConfig, ds, seed: int, batch: int) -> dict:
    """Seeded tiny weights under which ``evaluate`` detects events.

    At random weights every query of a clip leaves the decoder with the same
    output, and its mean over the clips outweighs how it varies from clip to
    clip: one class wins in every clip, and PSDS is zero.  So three biases
    move as in ``tests/test_torch_evaluate.py`` (the no-object logit down by
    3, the audio-tag logits up by 2, the box-length logit down by 1), and the
    class head is centred on its mean input over ``ds`` and scaled by 20, so
    the class scores follow the clip."""
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    head = model.class_embed
    inputs = []
    hook = head.register_forward_hook(lambda mod, x, out: inputs.append(x[0][-1].flatten(0, -2)))
    with torch.no_grad():
        for b in batch_iterator(ds, batch, cfg.model.max_events, cfg.features.max_len_seconds):
            model(b.feats, b.pad_mask)
        hook.remove()
        head.bias[-1] -= 3.0
        model.weak_class_embed.bias += 2.0
        model.bbox_embed.layer2.bias[1] -= 1.0
        head.bias -= 20.0 * head.weight @ torch.cat(inputs).mean(0)
        head.weight *= 20.0
    return model.state_dict()


def small_evaluate(dev: torch.device, seed: int) -> float:
    """``train_lib.evaluate`` at the tiny f32 geometry on the card (its
    feature bank there) against the CPU, TF32 off, on 48 clips at batch 4
    (``clip_following_weights``): the same event F1 per strategy and PSDS,
    with at least one F1 and one PSDS value non-zero, and the loss means to
    1e-3.  The exact comparison needs every score (and audio tag) of the CPU
    run more than 1e-5 from each decode threshold, unless it is the
    threshold itself; the two devices' scores differ by about 1e-6.  Returns
    the largest loss-mean difference."""
    cfg = SEDTConfig.tiny_test()
    m = cfg.model
    seconds = cfg.features.max_len_seconds
    enc = BoxEncoder(list(cfg.data.classes), seconds)
    ds = SyntheticDataset(48, cfg.data.classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                          max_events=3, seconds=seconds, seed=seed + 1)
    weights = clip_following_weights(cfg, ds, seed, 4)
    thresholds = train_lib.PSDS_THRESHOLDS
    runs = {}
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, wd = build_model(cfg, device=d)
            model.load_state_dict(weights, strict=True)
            step = make_eval_step(model, wd, cfg, FUSION, device=d)
            scores = []

            def recorded(batch, valid, step=step, scores=scores):
                res = step(batch, valid)
                scores.extend(res[f"pp_{k}"].scores.cpu() for k in FUSION)
                scores.append(res["at"].cpu())
                return res

            recorded.device = step.device
            res = train_lib.evaluate(
                recorded, ds, cfg, enc, ds.ref_rows(), FUSION, cal_seg=True, cal_clip=True,
                batch_size=4, psds_thresholds=thresholds, weight_dict=wd, bank=FeatureBank(ds, d))
            runs[d.type] = (res, torch.cat([t.flatten() for t in scores]).numpy())
    (ref, ref_scores), (got, _) = runs["cpu"], runs[dev.type]
    for t in (0.5,) + thresholds:
        near = (np.abs(ref_scores - t) < 1e-5) & (ref_scores != np.float32(t))
        assert not near.any(), f"a score within 1e-5 of the threshold {t}: {ref_scores[near]}"
    assert max(ref.f1.values()) > 0 and max(max(v) for v in ref.psds.values()) > 0, (
        f"F1 {ref.f1}, PSDS {ref.psds}: a comparison of zeros proves nothing")
    assert got.f1 == ref.f1, (got.f1, ref.f1)
    for k in FUSION:
        assert np.allclose(got.psds[k], ref.psds[k], rtol=0, atol=1e-9), k
    worst = 0.0
    for k, r in ref.loss_means.items():
        g = got.loss_means[k]
        assert np.isclose(g, r, rtol=1e-3, atol=1e-3), (k, g, r)
        worst = max(worst, abs(float(g - r)))
    print(f"tiny evaluate, card vs CPU: F1 {got.f1}, PSDS {got.psds}")
    return worst


def small_trainer(dev: torch.device) -> float:
    """``run_supervised`` at the tiny size (``TINY_TRAINER``: resnet18, d 64,
    1+1 layers, batch 4, 16 clips, 2 epochs, dropout 0, no augmentation,
    no fine-tune epoch, so no random draw differs) on the card and on the
    CPU, TF32 off: each epoch's train and validation loss means, and the F1
    of every strategy in every evaluation, to 1e-3.  Returns the largest
    difference."""
    runs = {}
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            root = Path(TRAIN_ROOT + "_tiny") / d.type
            shutil.rmtree(root, ignore_errors=True)
            runs[d.type] = train_lib.run_supervised(
                sedt_args(TINY_TRAINER + ["--exp_root", str(root)]), device=d)
    ref, got = runs["cpu"], runs[dev.type]
    pairs = []
    for r, g in zip(ref.epochs, got.epochs, strict=True):
        for key in ("loss_means", "val_loss_means", "val_f1"):
            pairs += [(f"epoch {r['epoch']} {key} {k}", g[key][k], v) for k, v in r[key].items()]
    for r, g in zip(ref.final, got.final, strict=True):
        pairs += [(f"final {r['fusion_strategy']} {k}", g[k], r[k])
                  for k in ("valid_f1", "eval_f1")]
    worst = 0.0
    for name, g, r in pairs:
        assert np.isfinite(g) and np.isclose(g, r, rtol=1e-3, atol=1e-3), (name, g, r)
        worst = max(worst, abs(float(g) - float(r)))
    f1s = [v for name, v, _ in pairs if "f1" in name]
    print(f"tiny trainer, card vs CPU: {len(pairs)} values, F1 from {min(f1s):.4f} to "
          f"{max(f1s):.4f}")
    return worst


def with_lsap_costs(call) -> tuple:
    """``call()``, with the cost of every ``lsap`` call it makes kept:
    (what ``call`` returns, [costs])."""
    seen = []
    matcher.lsap = lambda cost: (seen.append(cost.clone()), hungarian.lsap(cost))[1]
    try:
        out = call()
    finally:
        matcher.lsap = hungarian.lsap
    torch.cuda.synchronize()
    return out, seen


def step_flops(step, batch, gen) -> int:
    """The FLOPs of one train step as ``FlopCounterMode`` counts them on the
    port's own step (matrix products and convolutions, forward and
    backward)."""
    with FlopCounterMode(display=False) as counter:
        step(batch, gen)
    torch.cuda.synchronize()
    return counter.get_total_flops()


def split_train_step(model, wd, cfg, optimizer, batch, gen, card: str, iters: int = 5) -> None:
    """Forward and criterion / backward / optimizer split of the train step
    on the host clock, the card synchronised between the parts (in a step
    they overlap)."""
    loss_fn = make_loss_fn(model, wd, cfg)
    parts = collections.defaultdict(float)
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(batch.feats, batch.pad_mask, batch.targets, batch.strong, batch.weak,
                          gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        optimizer.step()
        torch.cuda.synchronize()
        parts["forward and criterion"] += t1 - t0
        parts["backward"] += t2 - t1
        parts["clip and AdamW"] += time.perf_counter() - t2
    for name, seconds in parts.items():
        print(f"train step part {name}: {seconds / iters * 1e3:.4f} ms/step ({card})")


def run_train_phases(dev: torch.device, card: str, latency: dict, clock_hz: float) -> dict:
    """Phase 4b: the flagship train step (then fine-tune and augmented);
    returns K1's launches, parity error and timing on the train step's own
    cost, for the ``kernels`` line."""
    cfg = flagship_config()
    m = cfg.model
    batch_size = cfg.data.batch_size
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = init_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, wd, cfg, state.optimizer, device=dev)
    batch = synthetic_batch(cfg, batch_size, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print("train step: " + describe(cfg, batch_size, sum(p.numel() for p in model.parameters()))
          + f", dropout {m.dropout}")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    assert frozen and buffers and trainable
    assert all(n.startswith(("backbone.conv1", "backbone.layer1_")) for n in frozen), sorted(frozen)

    metrics, costs = with_lsap_costs(lambda: step(batch, gen))  # warm-up 1, its cost kept
    (cost,) = costs
    assert cost.shape == (m.dec_layers * batch_size, m.num_queries, m.max_events), cost.shape
    k1_err = k1_against_references(cost.cpu().numpy(), dev, "the train step's own cost")
    for _ in range(TRAIN_WARMUP - 1):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_launch_counts()  # the main path: counts from here ...
    losses = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(step(batch, gen)["loss"])
    stop.record()
    stop.synchronize()
    host_s = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = launch_counts()  # ... to here
    event_ms = start.elapsed_time(stop) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all(), losses
    assert counts["K1"] == TRAIN_STEPS and counts["K4"] == 0 and counts["K2"] == 0, (
        f"the train step must launch K1 once a step and K4 never: {counts}")
    moved = [n for n, p in model.named_parameters() if p.requires_grad
             and not torch.equal(p.detach(), trainable[n])]
    assert len(moved) > 0.9 * len(trainable) and {"backbone.conv0.weight",
                                                   "class_embed.weight"} <= set(moved), (
        f"{len(moved)} of {len(trainable)} trainable parameters moved")
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), frozen[n]), f"frozen parameter {n} changed"
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), f"FrozenBN buffer {n} changed"
    print(f"train step: {event_ms:.3f} ms/step by CUDA events, {batch_size / event_ms * 1e3:.1f} "
          f"clips/s; {host_s * 1e3:.3f} ms/step by the host clock, {batch_size / host_s:.1f} "
          f"clips/s; {TRAIN_STEPS} steps, K1 {counts['K1']} launches, K4 {counts['K4']}; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}; {len(moved)} of {len(trainable)} "
          f"trainable parameters moved (not {sorted(set(trainable) - set(moved))}), "
          f"{len(frozen)} frozen ones and {len(buffers)} FrozenBN buffers unchanged; peak "
          f"memory {peak / 2**30:.3f} GiB ({card})")
    flops = step_flops(step, batch, gen)
    print(f"train step: {flops / 1e9:.1f} GFLOP a step counted by FlopCounterMode, "
          f"{flops / batch_size / 1e9:.2f} GFLOP a clip; at {event_ms:.3f} ms that is "
          f"{flops / (event_ms * 1e-3) / 1e12:.1f} TFLOP/s, {flops / (event_ms * 1e-3) / BF16_OPS_PER_S:.4f} "
          f"of the dense bf16 peak ({BF16_OPS_PER_S / 1e12:.0f} TFLOP/s) ({card})")
    profile(lambda: step(batch, gen), 3, "train step", card, "train_step_profile.txt")
    split_train_step(model, wd, cfg, state.optimizer, batch, gen, card)
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5, latency,
                     clock_hz)

    # the fine-tune stage: relaxed matching, lr fixed at 1e-5
    ft_state = init_train_state(model, cfg, steps_per_epoch=100, fixed_lr=1e-5)
    ft_step = make_train_step(model, wd, cfg, ft_state.optimizer, fine_tune=True, device=dev)
    ft_step(batch, gen)  # warm-up
    reset_launch_counts()  # the fine-tune path: counts from here ...
    ft, costs = with_lsap_costs(lambda: [ft_step(batch, gen)["loss"]
                                         for _ in range(FINE_TUNE_STEPS)])
    counts = launch_counts()  # ... to here
    ft = torch.stack(ft).cpu()
    assert torch.isfinite(ft).all(), ft
    assert counts["K1"] == 2 * FINE_TUNE_STEPS and counts["K4"] == 0, counts
    shapes = [list(c.shape) for c in costs]
    want = [[batch_size, m.num_queries, m.max_events],
            [(m.dec_layers - 1) * batch_size, m.num_queries, m.max_events]] * FINE_TUNE_STEPS
    assert shapes == want, shapes
    print(f"fine-tune step (lr 1e-5): losses {ft.tolist()}, K1 {counts['K1']} launches in "
          f"{FINE_TUNE_STEPS} steps at {shapes[:2]} ({card})")

    # the DCASE recipe's augmentations, and a time mask
    aug_cfg = cfg.replace(augment=dataclasses.replace(
        cfg.augment, mix_up_ratio=0.6, time_mask=True, freq_mask=True, freq_shift=True))
    aug_step = make_train_step(model, wd, aug_cfg, state.optimizer, device=dev)
    reset_launch_counts()  # the augmented path: counts from here ...
    aug = torch.stack([aug_step(batch, gen)["loss"] for _ in range(AUGMENT_STEPS)]).cpu()
    counts = launch_counts()  # ... to here
    assert torch.isfinite(aug).all() and counts["K1"] == AUGMENT_STEPS, (aug, counts)
    print(f"augmented step (mixup 0.6, time and frequency masks, frequency shift): losses "
          f"{aug.tolist()}, K1 {counts['K1']} launches in {AUGMENT_STEPS} steps ({card})")
    return {"launches": TRAIN_STEPS, "err": k1_err, "shape": list(cost.shape), "timing": timing}


# --------------------------------------------------------------- trainer


def trainer_launches(args, train: int, valid: int, test: int) -> dict:
    """K1's launches that the trainer's arguments call for on ``train``
    training, ``valid`` validation and ``test`` eval clips: one per plain
    train step, two per fine-tune step, one per eval batch (every
    ``eval_interval`` epochs' validation, then validation and eval for each
    strategy's final test)."""
    steps = train // args.batch_size
    plain = min(args.epochs, args.epochs_ls)
    batches = lambda n: -(-n // args.batch_size)
    evals = args.epochs // args.eval_interval * batches(valid)
    return {"train": steps * plain + 2 * steps * (args.epochs - plain),
            "eval": evals + len(args.fusion_strategy) * (batches(valid) + batches(test))}


def run_trainer_phase(dev: torch.device, card: str, latency: dict, clock_hz: float) -> dict:
    """Phase 4c: the supervised trainer at the flagship's widths through
    ``cli.sedt_args`` and ``train_lib.run_supervised``; returns K1's launches,
    parity error and timing on the cost of the run's first train step, for
    the ``kernels`` line.  Then one more run of one epoch, whose train epoch
    is profiled."""
    args = sedt_args(FLAGSHIP_TRAINER)
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)  # every checkpoint checked is this run's
    n_valid = max(8, args.smoke_clips // 4)  # build_synthetic_data's validation and eval set
    want = trainer_launches(args, args.smoke_clips, n_valid, n_valid)
    eval_launches = []
    real_evaluate = train_lib.evaluate

    def evaluate(*a, **kw):  # counts the eval steps' K1 launches apart
        before = hungarian.lsap_lane.launches
        out = real_evaluate(*a, **kw)
        eval_launches.append(hungarian.lsap_lane.launches - before)
        return out

    train_lib.evaluate = evaluate
    try:
        reset_launch_counts()  # the main path: counts from here ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, costs = with_lsap_costs(lambda: train_lib.run_supervised(args, device=dev))
        wall_s = time.perf_counter() - t0
        counts = launch_counts()  # ... to here
    finally:
        train_lib.evaluate = real_evaluate
    k1_eval = sum(eval_launches)
    k1_train = counts["K1"] - k1_eval
    assert (k1_train, k1_eval) == (want["train"], want["eval"]), (
        f"K1 launched {k1_train} times in train steps and {k1_eval} in eval steps, "
        f"not {want['train']} and {want['eval']}")
    assert counts["K2"] == counts["K3"] == counts["K4"] == 0, counts
    epochs = result.epochs
    assert [e["epoch"] for e in epochs] == list(range(args.epochs)), epochs
    assert all(np.isfinite(e["loss"]) for e in epochs), [e["loss"] for e in epochs]
    assert [e["fine_tune"] for e in epochs] == [e >= args.epochs_ls for e in range(args.epochs)]
    assert set(result.f1) == {args.fusion_strategy[-1]} and np.isfinite(list(result.f1.values())[0])
    assert [r["fusion_strategy"] for r in result.final] == list(args.fusion_strategy)
    assert all(set(e["val_f1"]) == set(args.fusion_strategy) for e in epochs)
    assert result.bank, "the trainer did not hold its features in a bank"
    cfg = train_lib.args_to_config(args)
    model, _ = build_model(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    for m in args.fusion_strategy:
        path = Path(result.model_dir) / f"{args.info}_{m}_best"
        assert path.is_file(), path
        model.load_state_dict(load_checkpoint(str(path))["model"], strict=True)
    del model
    rocs = [Path(TRAIN_ROOT) / "roc" / f"psds_roc_{t}.csv" for t in ("ct0_st0", "ct1_st0", "ct0_st1")]
    assert all(p.is_file() and p.stat().st_size > 0 for p in rocs), rocs

    batch = args.batch_size
    print(f"trainer: {describe(cfg, batch, n_params)}, {args.smoke_clips} training clips, {len(epochs)} epochs "
          f"(fine-tune from epoch {args.epochs_ls}), {wall_s:.3f} s in all ({card})")
    print(f"trainer K1 launches: {k1_train} in train steps, {k1_eval} in eval steps "
          f"({counts['K1']} in all); K2 {counts['K2']}, K3 {counts['K3']}, K4 {counts['K4']}")
    ckpt_s = 0.0
    for e in epochs:
        ms_step = e["train_s"] / e["steps"] * 1e3
        t = e["eval_timings"]
        ckpt_s += e.get("checkpoint_s", 0.0)
        print(f"trainer epoch {e['epoch']}{' (fine-tune)' if e['fine_tune'] else ''}"
              f"{' (cuDNN first calls)' if e['epoch'] == 0 else ''}: loss {e['loss']:.4f}, train "
              f"{e['train_s']:.3f} s for {e['steps']} steps = {ms_step:.3f} ms/step, "
              f"{batch * e['steps'] / e['train_s']:.1f} clips/s; eval steps "
              f"{t['eval_steps_s'] * 1e3:.3f} ms for {t['batches']} batches "
              f"({t['eval_steps_s'] / t['batches'] * 1e3:.3f} ms/batch), host decode "
              f"{t['decode_s'] * 1e3:.3f} ms, metrics {t['metrics_s'] * 1e3:.3f} ms; checkpoint "
              f"I/O {e.get('checkpoint_s', 0.0):.3f} s; F1 {e['val_f1']} ({card})")
    for r in result.final:
        v, t = r["valid_timings"], r["eval_timings"]
        ckpt_s += r.get("checkpoint_s", 0.0)
        print(f"trainer final test, strategy {r['fusion_strategy']}: validation eval steps "
              f"{v['eval_steps_s'] * 1e3:.3f} ms, decode {v['decode_s'] * 1e3:.3f} ms, metrics "
              f"{v['metrics_s'] * 1e3:.3f} ms; eval set eval steps {t['eval_steps_s'] * 1e3:.3f} "
              f"ms, decode {t['decode_s'] * 1e3:.3f} ms, metrics {t['metrics_s'] * 1e3:.3f} ms, "
              f"PSDS {t['psds_s'] * 1e3:.3f} ms (scores {r['psds'][r['fusion_strategy']]}); "
              f"checkpoint load {r.get('checkpoint_s', 0.0):.3f} s; F1 {r['valid_f1']:.4f} / "
              f"{r['eval_f1']:.4f} ({card})")
    steady = [e for e in epochs[1:] if not e["fine_tune"]]
    if steady:
        e = steady[0]
        print(f"trainer steady plain epoch: {e['train_s'] / e['steps'] * 1e3:.3f} ms/step, "
              f"{batch * e['steps'] / e['train_s']:.1f} clips/s; checkpoint I/O {ckpt_s:.3f} s "
              f"in all ({card})")

    cost = costs[0]  # the first train step's
    assert cost.shape == (cfg.model.dec_layers * batch, cfg.model.num_queries,
                          cfg.model.max_events), cost.shape
    err = k1_against_references(cost.cpu().numpy(), dev, "the trainer's own cost")
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5, latency,
                     clock_hz)

    # one more run of one epoch (cuDNN and the allocator warm), its train
    # epoch under the profiler
    root = TRAIN_ROOT + "_profiled"
    profiled_trainer_epoch(FLAGSHIP_TRAINER + ["--roc_curves", root + "/roc/"], root, dev,
                           f"trainer epoch ({args.smoke_clips // batch} steps)", card,
                           "trainer_profile.txt")
    return {"launches": counts["K1"], "err": err, "shape": list(cost.shape), "timing": timing}


def profiled_trainer_epoch(argv: list, exp_root: str, dev: torch.device, label: str, card: str,
                           file_name: str) -> None:
    """``run_supervised`` on ``argv`` for one epoch in a fresh ``exp_root``,
    its train epoch under the profiler."""
    shutil.rmtree(exp_root, ignore_errors=True)
    real_epoch = train_lib.train_one_epoch

    def profiled_epoch(*a, **kw):
        out = []
        profile(lambda: out.append(real_epoch(*a, **kw)), 1, label, card, file_name)
        return out[0]

    train_lib.train_one_epoch = profiled_epoch
    try:
        train_lib.run_supervised(sedt_args(argv + ["--exp_root", exp_root, "--epochs", "1"]),
                                 device=dev)
    finally:
        train_lib.train_one_epoch = real_epoch


# --------------------------------------------------------------- trainer on disk


def write_disk_data(root: str, card: str) -> dict:
    """Phase 4d's dataset: a seeded URBAN-SED layout (``DISK_CLIPS``) by the
    port's writer under ``root``, and beside it a seeded torchvision-layout
    ``resnet50.pth``, so the trainer's ``<data_root>/<backbone>.pth`` auto
    path is taken.  Returns the checkpoint's values."""
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    wav_dataset.write_urbansed(root, seed=SEED, **DISK_CLIPS)
    write_s = time.perf_counter() - t0
    n = sum(DISK_CLIPS.values())
    wav_bytes = sum(p.stat().st_size for p in Path(root).rglob("*.wav"))
    print(f"disk dataset: {n} clips of 10 s at 44.1 kHz ({DISK_CLIPS}), {wav_bytes / 1e6:.1f} MB "
          f"of wavs written in {write_s:.3f} s, {write_s / n * 1e3:.3f} ms a clip ({card})")
    rng = np.random.RandomState(SEED)
    state = {}
    for name, shape in torchvision_resnet_shapes("resnet50").items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.tensor(0)
        elif name.endswith("running_var"):
            state[name] = torch.from_numpy(rng.rand(*shape).astype(np.float32) + 0.5)
        else:
            state[name] = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.02)
    torch.save(state, Path(root) / "resnet50.pth")
    return torchvision_to_backbone(state)


def run_disk_trainer(args, dev: torch.device, want: dict, imagenet: dict) -> dict:
    """One counted run of ``run_supervised`` on disk; returns its result, K1's
    launches in train and in eval steps, the LSAP costs, the peak memory and
    the model's parameter count.  Checks the backbone as loaded (the file's
    values leaf for leaf, conv0 its own init), the launch counts, the losses
    and that every best checkpoint loads back."""
    eval_launches, loaded = [], []
    real_evaluate, real_init = train_lib.evaluate, train_lib._imagenet_backbone_init

    def evaluate(*a, **kw):  # counts the eval steps' K1 launches apart
        before = hungarian.lsap_lane.launches
        out = real_evaluate(*a, **kw)
        eval_launches.append(hungarian.lsap_lane.launches - before)
        return out

    def backbone_init(model, a, log):
        conv0 = {k: v.clone() for k, v in model.backbone.conv0.state_dict().items()}
        path = real_init(model, a, log)
        own = model.backbone.state_dict()
        assert path == str(Path(args.data_root) / "resnet50.pth"), path
        assert set(own) - set(imagenet) == {"conv0.weight", "conv0.bias"}
        for k, v in imagenet.items():
            assert torch.equal(own[k].cpu(), v), f"backbone leaf {k} is not the file's"
        for k, v in model.backbone.conv0.state_dict().items():
            assert torch.equal(v, conv0[k]), f"conv0.{k} changed"
        loaded.append(path)
        return path

    train_lib.evaluate, train_lib._imagenet_backbone_init = evaluate, backbone_init
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()  # the main path: counts from here ...
        result, costs = with_lsap_costs(lambda: train_lib.run_supervised(args, device=dev))
        counts = launch_counts()  # ... to here
    finally:
        train_lib.evaluate, train_lib._imagenet_backbone_init = real_evaluate, real_init
    peak = torch.cuda.max_memory_allocated(dev)
    k1_eval = sum(eval_launches)
    k1_train = counts["K1"] - k1_eval
    assert loaded, "the trainer did not load the ImageNet backbone"
    assert (k1_train, k1_eval) == (want["train"], want["eval"]), (
        f"K1 launched {k1_train} times in train steps and {k1_eval} in eval steps, "
        f"not {want['train']} and {want['eval']}")
    assert counts["K2"] == counts["K3"] == counts["K4"] == 0, counts
    epochs = result.epochs
    assert [e["epoch"] for e in epochs] == list(range(args.epochs)), epochs
    assert all(np.isfinite(e["loss"]) for e in epochs), [e["loss"] for e in epochs]
    assert [e["fine_tune"] for e in epochs] == [e >= args.epochs_ls for e in range(args.epochs)]
    assert [r["fusion_strategy"] for r in result.final] == list(args.fusion_strategy)
    model, _ = build_model(train_lib.args_to_config(args), device=dev)
    for m in args.fusion_strategy:
        path = Path(result.model_dir) / f"{args.info}_{m}_best"
        assert path.is_file(), path
        model.load_state_dict(load_checkpoint(str(path))["model"], strict=True)
    return {"result": result, "k1_train": k1_train, "k1_eval": k1_eval, "costs": costs,
            "peak": peak, "n_params": sum(p.numel() for p in model.parameters())}


def report_disk_run(label: str, result, args, peak: int, card: str) -> None:
    batch = args.batch_size
    ckpt_s = 0.0
    for e in result.epochs:
        t = e["eval_timings"]
        ckpt_s += e.get("checkpoint_s", 0.0)
        print(f"disk trainer {label} epoch {e['epoch']}{' (fine-tune)' if e['fine_tune'] else ''}: "
              f"loss {e['loss']:.4f}, {e['train_s'] / e['steps'] * 1e3:.3f} ms/step, "
              f"{batch * e['steps'] / e['train_s']:.1f} clips/s, data wait "
              f"{e['data_wait_s'] / e['steps'] * 1e3:.3f} ms/step ({e['data_wait_s']:.3f} s in "
              f"{e['steps']} steps); eval steps {t['eval_steps_s'] * 1e3:.3f} ms for "
              f"{t['batches']} batches, host decode {t['decode_s'] * 1e3:.3f} ms, metrics "
              f"{t['metrics_s'] * 1e3:.3f} ms; checkpoint I/O {e.get('checkpoint_s', 0.0):.3f} s "
              f"({card})")
    for r in result.final:
        v, t = r["valid_timings"], r["eval_timings"]
        ckpt_s += r.get("checkpoint_s", 0.0)
        print(f"disk trainer {label} final test, strategy {r['fusion_strategy']}: validation "
              f"eval steps {v['eval_steps_s'] * 1e3:.3f} ms, eval set eval steps "
              f"{t['eval_steps_s'] * 1e3:.3f} ms, decode {t['decode_s'] * 1e3:.3f} ms, metrics "
              f"{t['metrics_s'] * 1e3:.3f} ms, PSDS {t['psds_s'] * 1e3:.3f} ms; F1 "
              f"{r['valid_f1']:.4f} / {r['eval_f1']:.4f} ({card})")
    print(f"disk trainer {label}: checkpoint I/O {ckpt_s:.3f} s in all, peak memory "
          f"{peak / 2**30:.3f} GiB ({card})")


def wav_batch_split(args, dev: torch.device, card: str) -> None:
    """Where one ``--from_wavs`` train batch of the disk dataset spends its
    time: on the host clock, reading its clips from disk (the first epoch)
    or from ``WavLoadDf``'s RAM cache (later epochs), ``collate`` (stack and
    targets) and pinning, the prefetch thread's work; on CUDA events, the
    copy to the card and the frontend."""
    data = train_lib.build_real_data(train_lib.args_to_config(args), args)
    ds, fe = data["train"], data["frontend"]
    cfg = train_lib.args_to_config(args)
    idx = list(range(args.batch_size))
    t0 = time.perf_counter()
    samples = [ds[i] for i in idx]  # from disk: ds keeps them in RAM after this
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = [ds[i] for i in idx]
    cached_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = collate(samples, cfg.model.max_events, cfg.features.max_len_seconds)
    collate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pinned = batch.feats.pin_memory()
    pin_s = time.perf_counter() - t0
    frontend = make_frontend_fn(max_frames=cfg.model.max_frames, compute_log=True, **fe)
    feats = pinned.to(dev)
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5)
    with torch.no_grad():
        frontend_ms = cuda_ms(lambda: frontend(feats), 5)
    print(f"--from_wavs batch of {args.batch_size} ({pinned.numel() * 4 / 1e6:.1f} MB): read "
          f"from disk {read_s * 1e3:.3f} ms, from the RAM cache {cached_s * 1e3:.3f} ms, collate "
          f"{collate_s * 1e3:.3f} ms, pin {pin_s * 1e3:.3f} ms (host clock, one thread); copy "
          f"to the card {copy_ms:.3f} ms, frontend {frontend_ms:.3f} ms (CUDA events) ({card})")


def run_disk_phase(dev: torch.device, card: str, latency: dict, clock_hz: float) -> dict:
    """Phase 4d: the flagship trainer at 500 x 64 on a seeded URBAN-SED
    dataset on disk, first on the ``.npy`` cache (which it extracts), then
    with ``--from_wavs``; each then profiled over one more epoch.  Returns
    K1's launches, parity error and timing on the cost of the run's first
    train step, for the ``kernels`` line."""
    imagenet = write_disk_data(DISK_ROOT, card)
    want = trainer_launches(sedt_args(FLAGSHIP_DISK), DISK_CLIPS["train"],
                            DISK_CLIPS["validate"], DISK_CLIPS["test"])
    runs = {}
    for label, extra in (("npy", []), ("wav", ["--from_wavs"])):
        exp = f"{DISK_EXP}_{label}"
        shutil.rmtree(exp, ignore_errors=True)  # a fresh scaler, and every checkpoint this run's
        args = sedt_args(FLAGSHIP_DISK + extra + ["--exp_root", exp])
        t0 = time.perf_counter()
        run = run_disk_trainer(args, dev, want, imagenet)
        wall_s = time.perf_counter() - t0
        result = run["result"]
        # --from_wavs streams the audio: no bank for the train batches
        assert result.bank == (label == "npy"), f"{label}: bank {result.bank}"
        d = result.data_timings
        cfg = train_lib.args_to_config(args)
        if label == "npy":
            assert d["extracted"] == d["clips"] == sum(DISK_CLIPS.values()), d
            print(f"disk trainer: {describe(cfg, args.batch_size, run['n_params'])}, ImageNet "
                  f"backbone from {args.data_root}/resnet50.pth")
            print(f"disk trainer feature extraction: {d['extracted']} clips in "
                  f"{d['features_s']:.3f} s, {d['features_s'] / d['extracted'] * 1e3:.3f} ms a clip "
                  f"(read, STFT, mel, np.save on the host); scaler pass {d['scaler_s']:.3f} s over "
                  f"{DISK_CLIPS['train']} clips ({card})")
        else:
            assert d["extracted"] == 0, d  # the .npy run's cache serves validation and eval
            print(f"disk trainer --from_wavs: scaler pass {d['scaler_s']:.3f} s; the train "
                  f"batches carry {args.batch_size} x {int(cfg.features.max_len_seconds * cfg.features.sample_rate)} "
                  f"samples ({card})")
        print(f"disk trainer {label}: {wall_s:.3f} s in all; K1 {run['k1_train']} launches in "
              f"train steps, {run['k1_eval']} in eval steps; K2-K4 none ({card})")
        report_disk_run(label, result, args, run["peak"], card)
        runs[label] = (run["k1_train"] + run["k1_eval"], run["costs"])
    wav_batch_split(sedt_args(FLAGSHIP_DISK + ["--from_wavs", "--exp_root", f"{DISK_EXP}_wav"]),
                    dev, card)
    for label, extra in (("npy", []), ("wav", ["--from_wavs"])):
        profiled_trainer_epoch(FLAGSHIP_DISK + extra, f"{DISK_EXP}_{label}_profiled", dev,
                               f"disk trainer epoch ({label})", card,
                               f"disk_trainer_{label}_profile.txt")
    launches, costs = runs["npy"]
    cost = costs[0]  # the first train step's
    err = k1_against_references(cost.cpu().numpy(), dev, "the disk trainer's own cost")
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5, latency,
                     clock_hz)
    return {"launches": launches, "wav_launches": runs["wav"][0], "err": err,
            "shape": list(cost.shape), "timing": timing}


def small_disk_trainers(dev: torch.device) -> float:
    """``run_supervised`` at the tiny size on small seeded datasets on disk
    (URBAN-SED ``.npy``, URBAN-SED ``--from_wavs``, DCASE ``.npy`` with a
    weak stream), on the card and on the CPU, TF32 off: each epoch's train
    and validation loss means to 1e-3.  Returns the largest difference."""
    shutil.rmtree(TINY_DISK_ROOT, ignore_errors=True)
    wav_dataset.write_urbansed(TINY_DISK_ROOT, train=8, validate=4, test=4, seed=SEED)
    wav_dataset.write_dcase(TINY_DISK_ROOT, strong=4, weak=4, unlabel=0, validate=4, test=4,
                            seed=SEED)
    worst = 0.0
    for extra in (["--dataname", "urbansed"], ["--dataname", "urbansed", "--from_wavs"],
                  ["--dataname", "dcase", "--n_weak", "2"]):
        runs = {}
        with cudnn_tf32_off():
            for d in (torch.device("cpu"), dev):
                root = Path(TINY_DISK_ROOT + "_exp") / d.type
                shutil.rmtree(root, ignore_errors=True)
                runs[d.type] = train_lib.run_supervised(
                    sedt_args(TINY_DISK + extra + ["--exp_root", str(root)]), device=d)
        pairs = []
        for r, g in zip(runs["cpu"].epochs, runs[dev.type].epochs, strict=True):
            for key in ("loss_means", "val_loss_means"):
                pairs += [(f"{extra} epoch {r['epoch']} {key} {k}", g[key][k], v)
                          for k, v in r[key].items()]
        for name, g, r in pairs:
            assert np.isfinite(g) and np.isclose(g, r, rtol=1e-3, atol=1e-3), (name, g, r)
            worst = max(worst, abs(float(g) - float(r)))
        print(f"tiny disk trainer {' '.join(extra[1:])}, card vs CPU: {len(pairs)} loss means "
              f"agree to 1e-3")
    return worst


# --------------------------------------------------------------- predict


def long_config(base: SEDTConfig, seconds: float, max_frames: int, **model_kw) -> SEDTConfig:
    """``base`` at a longer clip: the features' length and the model's frame
    count (and any other model field) replaced, everything else as it was."""
    return base.replace(
        features=dataclasses.replace(base.features, max_len_seconds=seconds),
        model=dataclasses.replace(base.model, max_frames=max_frames, **model_kw))


def make_waveforms(cfg: SEDTConfig, batch: int, seed: int) -> np.ndarray:
    """[batch, n_samples] f32: a noise floor with a few tone bursts; the last
    clip is short and zero-padded, as a ragged batch's tail is."""
    fc = cfg.features
    n = int(fc.max_len_seconds * fc.sample_rate)
    rng = np.random.default_rng(seed)
    waves = rng.standard_normal((batch, n), dtype=np.float32) * 0.02
    t = np.arange(n, dtype=np.float32) / fc.sample_rate
    for i in range(batch):
        for _ in range(4):
            start, dur = rng.uniform(0, 0.8), rng.uniform(0.05, 0.2)
            seg = slice(int(start * n), int((start + dur) * n))
            waves[i, seg] += 0.3 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t[seg])
    waves[-1, n // 3:] = 0.0
    return waves


def small_long_predict(dev: torch.device, seed: int) -> float:
    """The tiny f32 predict on clips long enough for 528 encoder tokens, on
    the card (K4) against the CPU (the plain non-flash path), TF32 off;
    returns the largest score or box difference, held to 1e-3."""
    cfg = long_config(SEDTConfig.tiny_test(), 4224 * 128 / 8000, 4224)
    waves = make_waveforms(cfg, 2, seed)
    res = {}
    before = flash_attention.flash_attention.launches
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, _ = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
            res[d.type] = [t.cpu() for t in make_infer(cfg, model, device=d)(waves)]
    launched = flash_attention.flash_attention.launches - before
    want = cfg.model.enc_layers + cfg.model.dec_layers
    assert launched == want, f"K4 launched {launched} times in the tiny long predict, not {want}"
    check_predictions(*res["cuda"], cfg, 2)
    worst = 0.0
    for g, r in zip(res["cuda"], res["cpu"]):
        assert torch.allclose(g.float(), r.float(), rtol=1e-3, atol=1e-3)
        worst = max(worst, float((g.float() - r.float()).abs().max()))
    return worst


def synthetic_scaler(n_mels: int) -> Scaler:
    """Per-band statistics of the size a log-mel dataset has (dB)."""
    sc = Scaler()
    mean = np.linspace(-30.0, -50.0, n_mels)
    sc.load_state_dict({"mean_": mean.tolist(), "mean_of_square_": (mean**2 + 15.0**2).tolist()})
    return sc


def run_long_predict(cfg: SEDTConfig, model, dev: torch.device, card: str) -> dict:
    """Phase 5: the 60 s flagship predict, batch 8; returns K4's launches per
    shape in the counted run."""
    m, fc = cfg.model, cfg.features
    waves = torch.from_numpy(make_waveforms(cfg, LONG_BATCH, SEED))
    scaler = synthetic_scaler(fc.n_mels)
    infer = make_infer(cfg, model, scaler, at_m=1, device=dev)
    enc = BoxEncoder(list(cfg.data.classes), seconds=fc.max_len_seconds)
    print(f"long predict: {fc.max_len_seconds:.0f} s clips, {waves.shape[1]} samples, "
          f"{m.max_frames}x{m.n_mels} frames, queries {m.num_queries}+dec_at, batch {LONG_BATCH}, "
          f"compute {m.compute_dtype}")

    # K4's shapes as the model hands them over, tallied beside the wrapper's own count
    seen = collections.Counter()
    real = flash_attention.flash_attention
    def tally(q, k, v, bias=None):
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16 and bias.dtype == torch.float32
        seen[(q.shape[2], k.shape[2])] += 1
        return real(q, k, v, bias)
    attention.flash_attention = tally
    infer(waves)  # warm-up: cuDNN picks its algorithms, the allocator its blocks
    torch.cuda.synchronize()
    seen.clear()

    reset_launch_counts()  # the main path: counts from here ...
    t0 = time.perf_counter()
    for _ in range(LONG_FORWARDS):
        scores, labels, boxes = infer(waves)
        events = enc.decode_strong_batch(scores.cpu().numpy(), labels.cpu().numpy(),
                                         boxes.cpu().numpy(), threshold=0.0)
    batch_s = (time.perf_counter() - t0) / LONG_FORWARDS
    counts = launch_counts()  # ... to here
    attention.flash_attention = real
    per_forward = m.enc_layers + m.dec_layers
    assert counts["K4"] == per_forward * LONG_FORWARDS == sum(seen.values()), (counts, seen)
    assert counts["K4 tensor"] == counts["K4"] and counts["K4 f32"] == 0, (
        f"a long forward's K4 launches must all be the tensor-core variant: {counts}")
    assert counts["K4 split"] == m.dec_layers * LONG_FORWARDS, (
        f"the cross-attention launches, and only they, split the keys: {counts}")
    tokens = -(-m.max_frames // 16) * (m.n_mels // 16)
    assert seen == {(tokens, tokens): m.enc_layers * LONG_FORWARDS,
                    (m.num_queries + 1, tokens): m.dec_layers * LONG_FORWARDS}, seen
    check_predictions(scores, labels, boxes, cfg, LONG_BATCH)
    n_events = sum(len(v) for v in events.values())
    assert n_events > 0
    for rows in events.values():
        assert all(0.0 <= on <= off <= fc.max_len_seconds + 1e-3 for _, on, off, _ in rows)
    print(f"long predict: {batch_s * 1e3:.3f} ms/batch with the host decode, "
          f"{LONG_BATCH * fc.max_len_seconds / batch_s:.1f} s of audio per second, K4 "
          f"{counts['K4']} launches in {LONG_FORWARDS} forwards (tensor-core variant "
          f"{counts['K4 tensor']}, of which {counts['K4 split']} split the keys; f32-core "
          f"variant {counts['K4 f32']}), {n_events} events decoded at "
          f"threshold 0 over {len(events)} clips (random weights) ({card})")

    # the split of one batch, on the device clock
    frontend = make_frontend_fn(
        sr=fc.sample_rate, n_fft=fc.n_fft, n_window=fc.n_window, hop=fc.hop_size,
        n_mels=fc.n_mels, max_frames=m.max_frames, scaler_mean=scaler.mean_,
        scaler_std=scaler.std_, compute_log=fc.compute_log)
    with torch.inference_mode():
        waves_dev = waves.to(dev)
        feats = frontend(waves_dev)
        pad = torch.zeros(feats.shape[:2], dtype=torch.bool, device=dev)
        out = model(feats, pad)
        tags = (out["at"] > 0.5).float()
        sizes = torch.full((LONG_BATCH,), fc.max_len_seconds, device=dev)
        parts = {
            "host-to-device copy": lambda: waves.to(dev),
            "frontend": lambda: frontend(waves_dev),
            "forward": lambda: model(feats, pad),
            "postprocess": lambda: postprocess(out, sizes, audio_tags=tags, at_m=1),
        }
        for name, fn in parts.items():
            print(f"long predict part {name}: {cuda_ms(fn, 5, warmup=1):.4f} ms/batch ({card})")
    profile(lambda: infer(waves), 3, "long predict", card, "long_predict_profile.txt")
    return {sq: n for (sq, _), n in seen.items()}


# --------------------------------------------------------------- profile


def profile(fn, calls: int, label: str, card: str, file_name: str) -> None:
    """A torch.profiler table of ``calls`` calls of ``fn``, written to
    chiprun_out/, and the device's busy and idle share of them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched, and a user annotation on the
    # device's timeline (the optimizer's step) spans kernels already counted
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    print(f"profiled {calls} x {label}: device busy {busy_us / calls / 1e3:.3f} ms each in "
          f"{sum(r[2] for r in rows) // calls} kernels and copies, "
          f"{wall_us / calls / 1e3:.3f} ms each wall under the profiler, idle share "
          f"{1 - busy_us / wall_us:.4f} ({card})")
    lines = [f"{t / calls / 1e3:10.4f} ms each {c // calls:6d} each  {k[:140]}"
             for k, t, c in rows]
    for line in lines[:12]:
        print("  " + line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / file_name).write_text(
        f"{card}\n" + "\n".join(lines) + "\n\n"
        + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))


def split_eval_step(model, cfg, batch_cpu, valid, card: str) -> None:
    """Forward / criterion / post-processing split of one step (CUDA events)."""
    dev = next(model.parameters()).device
    feats, pad = batch_cpu.feats.to(dev), batch_cpu.pad_mask.to(dev)
    targets = type(batch_cpu.targets)(*(t.to(dev) for t in batch_cpu.targets))
    strong = batch_cpu.strong.to(dev) & valid.to(dev)
    with torch.inference_mode():
        out = model(feats, pad)
        at = (out["at"] > 0.5).float()
        parts = {
            "forward": lambda: model(feats, pad),
            "criterion": lambda: set_criterion(out, targets, strong, None, cfg.model, cfg.loss),
            "postprocess": lambda: [postprocess(out, targets.orig_size, at, at_m=m)
                                    for m in FUSION],
        }
        for name, fn in parts.items():
            print(f"eval step part {name}: {cuda_ms(fn, 10):.4f} ms/batch ({card})")


def first_step_cost(step, batch, valid) -> tuple:
    """One (warm-up) step with the Hungarian cost it hands to ``lsap`` kept."""
    res, (cost,) = with_lsap_costs(lambda: step(batch, valid))
    return res, cost


def describe(cfg: SEDTConfig, batch: int, n_params: int) -> str:
    m = cfg.model
    return (f"{m.backbone} dilation={m.dilation} enc/dec {m.enc_layers}/{m.dec_layers} "
            f"d {m.hidden_dim} heads {m.nheads} ffn {m.dim_feedforward} queries {m.num_queries}"
            f"+dec_at slots {m.max_events} input {m.max_frames}x{m.n_mels} batch {batch} "
            f"compute {m.compute_dtype}, {n_params} parameters")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs one GPU")
    dev = torch.device("cuda", 0)

    # 1. environment and build
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}")
    for name, seconds in build_kernels().items():
        print(f"kernel build {name}: {seconds:.2f} s ({card})")
    clock_hz = sm_clock_hz()
    latency = latency_probe(dev)
    print(f"dependent-step latencies timed by one warp on the card, in cycles: "
          + ", ".join(f"{k} {v:.2f}" for k, v in latency.items())
          + f"; highest SM clock {clock_hz / 1e6:.0f} MHz ({card})")

    # 2. every kernel against its plain version (and scipy, and the non-flash path)
    errs = check_kernels(dev)

    # 3. the tiny f32 paths on the card against the CPU
    worst = small_reference(dev, SEED)
    print(f"tiny f32 eval step, card vs CPU: ok, max |loss difference| {worst:.3g}")
    worst = small_long_predict(dev, SEED)
    print(f"tiny f32 long predict (K4 on the card, non-flash path on the CPU): ok, "
          f"max |score or box difference| {worst:.3g}")
    worst = small_train_step(dev, SEED)
    print(f"tiny f32 train step, 2 steps, card vs CPU: ok, max |loss or parameter difference| "
          f"{worst:.3g}")
    worst = small_evaluate(dev, SEED)
    print(f"tiny f32 evaluate, card vs CPU: ok, max |loss mean difference| {worst:.3g}")
    worst = small_trainer(dev)
    print(f"tiny f32 trainer, 2 epochs, card vs CPU: ok, max |loss mean or F1 difference| "
          f"{worst:.3g}")
    worst = small_disk_trainers(dev)
    print(f"tiny f32 trainers on disk (URBAN-SED .npy and --from_wavs, DCASE .npy), 2 epochs, "
          f"card vs CPU: ok, max |loss mean difference| {worst:.3g}")

    # 4. the flagship evaluation step, 10 s clips
    cfg = SEDTConfig.urbansed_supervised()
    m = cfg.model
    batch = cfg.data.batch_size
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    enc, batches = make_batches(cfg, batch, 2, SEED)
    valid = torch.ones(batch, dtype=torch.bool)
    step = make_eval_step(model, wd, cfg, FUSION, device=dev)
    print("flagship: " + describe(cfg, batch, sum(p.numel() for p in model.parameters())))
    res, cost = first_step_cost(step, batches[0], valid)
    check_eval_result(res, wd, cfg, batch)
    assert cost.shape == (m.dec_layers * batch, m.num_queries, m.max_events), cost.shape
    step_err = k1_against_references(cost.cpu().numpy(), dev, "the step's own cost")
    errs["K1"] = max(errs["K1"], step_err)
    print(f"K1 on the step's own cost {list(cost.shape)}: ok vs plain and scipy, "
          f"max |cost - optimum| {step_err:.3g}")
    pp = res["pp_1"]
    decoded = enc.decode_strong_batch(pp.scores.cpu().numpy(), pp.labels.cpu().numpy(),
                                      pp.boxes.cpu().numpy(), threshold=0.0)
    n_events = sum(len(v) for v in decoded.values())
    assert n_events > 0
    print(f"decoded {n_events} events over {len(decoded)} clips at threshold 0 "
          f"(random weights); losses: "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(res['losses'].items())
                      if not k[-1].isdigit()))

    reset_launch_counts()  # the main path: counts from here ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        res = step(batches[i % len(batches)], valid)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS
    launches = {"K1": launch_counts()["K1"]}  # ... to here
    check_eval_result(res, wd, cfg, batch)
    assert launches["K1"] == STEPS, f"K1 launched {launches['K1']} times in {STEPS} steps"
    print(f"eval step: {step_s * 1e3:.3f} ms/batch, {batch / step_s:.1f} clips/s, "
          f"{STEPS} steps, batch {batch} ({card})")
    timing = {"K1": time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5,
                            latency, clock_hz)}
    time_k1_shapes(dev, card, clock_hz)
    shapes = {"K1": list(cost.shape)}
    split_eval_step(model, cfg, batches[0], valid, card)
    profile(lambda: step(batches[0], valid), 3, "eval step", card, "eval_step_profile.txt")
    del model, step

    # 4b. the flagship train step, then the fine-tune and augmented steps
    train = run_train_phases(dev, card, latency, clock_hz)
    errs["K1"] = max(errs["K1"], train["err"])
    torch.cuda.empty_cache()

    # 4c. the supervised trainer at the flagship's widths
    trainer = run_trainer_phase(dev, card, latency, clock_hz)
    errs["K1"] = max(errs["K1"], trainer["err"])
    torch.cuda.empty_cache()

    # 4d. the flagship trainer on a dataset on disk, .npy and --from_wavs
    disk = run_disk_phase(dev, card, latency, clock_hz)
    errs["K1"] = max(errs["K1"], disk["err"])
    torch.cuda.empty_cache()

    # 5. long-clip predict at the flagship's width
    long_cfg = long_config(cfg, LONG_SECONDS, int(LONG_SECONDS * 50), num_queries=40,
                           max_events=60)
    lm = long_cfg.model
    model, wd = build_model(long_cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    print("long clip: " + describe(long_cfg, LONG_BATCH, sum(p.numel() for p in model.parameters())))
    k4_launches = run_long_predict(long_cfg, model, dev, card)

    # 6. the long-clip evaluation step
    _, batches = make_batches(long_cfg, LONG_BATCH, 2, SEED, seconds=LONG_SECONDS, clip_events=30)
    valid = torch.ones(LONG_BATCH, dtype=torch.bool)
    step = make_eval_step(model, wd, long_cfg, FUSION, device=dev)
    res, cost = first_step_cost(step, batches[0], valid)
    check_eval_result(res, wd, long_cfg, LONG_BATCH)
    assert cost.shape == (lm.dec_layers * LONG_BATCH, lm.num_queries, lm.max_events), cost.shape
    cost_np = cost.cpu().numpy()
    e2 = k2_against_references(cost_np, dev, "the long step's own cost")
    errs["K2"] = max(errs["K2"], e2)
    reset_launch_counts()  # K3's path is its entry point: counts from here ...
    square = matcher._square_pad(cost)
    by_k3 = hungarian.lsap_square(square).cpu().numpy()
    counts = launch_counts()  # ... to here
    launches["K3"] = counts["K3"]
    assert launches["K3"] == counts["K3 warp"] == 1, (
        f"K3 on the long step's square-padded cost must be one launch of its warp variant: "
        f"{counts}")
    best = scipy_optimum(cost_np)
    k3_cost = assignment_cost(cost_np, np.where(by_k3 < lm.num_queries, by_k3, -1).astype(np.int32))
    assert (np.abs(k3_cost - best) <= 1e-2 * np.maximum(1.0, np.abs(best))).all()
    errs["K3"] = max(errs["K3"], float(np.abs(k3_cost - best).max()))
    print(f"long step's own cost {list(cost.shape)}: K2 ok vs plain and scipy (max |cost - "
          f"optimum| {e2:.3g}), K3 on the square-padded copy {list(square.shape)} reaches "
          f"scipy's optimum (max difference {float(np.abs(k3_cost - best).max()):.3g})")

    reset_launch_counts()  # the main path: counts from here ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LONG_STEPS):
        res = step(batches[i % len(batches)], valid)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LONG_STEPS
    counts = launch_counts()  # ... to here
    check_eval_result(res, wd, long_cfg, LONG_BATCH)
    per_forward = lm.enc_layers + lm.dec_layers
    assert counts["K2"] == LONG_STEPS and counts["K1"] == 0, counts
    assert counts["K2 warp"] == counts["K2"] and counts["K2 block"] == 0, (
        f"the long step's K2 launch must be the warp variant: {counts}")
    assert counts["K4"] == per_forward * LONG_STEPS, counts
    assert counts["K4 tensor"] == counts["K4"] and counts["K4 f32"] == 0, (
        f"the long step's K4 launches must all be the tensor-core variant: {counts}")
    launches["K2"] = counts["K2"]
    print(f"long eval step: {step_s * 1e3:.3f} ms/batch, K2 {counts['K2']} (warp variant "
          f"{counts['K2 warp']}) and K4 {counts['K4']} (tensor-core variant "
          f"{counts['K4 tensor']}, {counts['K4 split']} with the keys split) launches in "
          f"{LONG_STEPS} steps, batch {LONG_BATCH} ({card})")

    # 7. kernel times at the long path's shapes
    timing["K2"] = time_jv("K2", hungarian.lsap_block, hungarian.lsap_plain, cost, card, 3,
                           latency, clock_hz)
    timing["K3"] = time_jv("K3", hungarian.lsap_square, hungarian.lsap_square_plain, square,
                           card, 1, latency, clock_hz, plain_warmup=0)  # plain takes seconds
    shapes["K2"], shapes["K3"] = list(cost.shape), list(square.shape)
    rng = np.random.RandomState(SEED + 1)
    tokens = -(-lm.max_frames // 16) * (lm.n_mels // 16)
    k4_shapes = {"encoder": (tokens, tokens), "cross": (lm.num_queries + 1, tokens)}
    for name, (sq, sk) in k4_shapes.items():
        timing[f"K4 {name}"] = time_k4(rng, sq, sk, dev, card, clock_hz)

    hungarian_src = SOURCE_DIR + "hungarian_jv.cu"
    kernels = [
        {"name": "K1 lsap_lane", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": shapes["K1"], "launches": launches["K1"], "variant": "warp, 1 column a lane",
         "max_abs_err": errs["K1"], **timing["K1"]},
        {"name": "K1 lsap_lane train step", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": train["shape"], "launches": train["launches"],
         "variant": "warp, 1 column a lane", "max_abs_err": errs["K1"], **train["timing"]},
        {"name": "K1 lsap_lane trainer", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": trainer["shape"], "launches": trainer["launches"],
         "variant": "warp, 1 column a lane", "max_abs_err": errs["K1"], **trainer["timing"]},
        {"name": "K1 lsap_lane disk trainer", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": disk["shape"], "launches": disk["launches"],
         "launches_from_wavs": disk["wav_launches"],
         "variant": "warp, 1 column a lane", "max_abs_err": errs["K1"], **disk["timing"]},
        {"name": "K2 lsap_block", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:197", "tpu_kernel": "_jv_packed_kernel",
         "shape": shapes["K2"], "launches": launches["K2"],
         "variant": f"{hungarian.block_variant(*shapes['K2'][1:])}, "
                    f"{warp_columns('K2', shapes['K2'][2])} columns a lane",
         "max_abs_err": errs["K2"], **timing["K2"]},
        # K3 is on neither main path (no module of either package dispatches to
        # it): its one launch is its own entry point, lsap_square, called above
        {"name": "K3 lsap_square", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:120", "tpu_kernel": "_jv_kernel",
         "shape": shapes["K3"], "launches": launches["K3"],
         "variant": f"{hungarian.square_variant(shapes['K3'][2])}, "
                    f"{warp_columns('K3', shapes['K3'][2])} columns a lane",
         "on_a_main_path": False, "max_abs_err": errs["K3"], **timing["K3"]},
    ]
    for name, (sq, sk) in k4_shapes.items():
        kernels.append(
            {"name": f"K4 flash_attention {name}", "source": SOURCE_DIR + "flash_attention.cu",
             "replaces": PALLAS_DIR + "flash_attention.py:35", "tpu_kernel": "_flash_kernel",
             "shape": {"q": [LONG_BATCH, 8, sq, 32], "kv": [LONG_BATCH, 8, sk, 32],
                       "dtype": "bfloat16"},
             "launches": k4_launches[sq],
             "variant": "tensor, keys split" if name == "cross" else "tensor",
             "max_abs_err": errs[f"K4 {sq}"],
             "max_abs_err_f32": errs["K4 float32"], **timing[f"K4 {name}"]})
    for kernel in kernels:
        kernel.update(route="cuda", parity="ok")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
