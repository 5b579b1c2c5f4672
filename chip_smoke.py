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
   K4's backward kernels at the tensor-core variant's shapes, a slice of
   AST's batch and AST's whole [64, 12, 1214, 64] against the plain backward
   in f32 on the same bf16 inputs (each gradient to ``K4_BACKWARD_TOL`` of
   its largest entry, one kernel call and no recompute through autograd,
   each row's log-sum-exp against ``torch.logsumexp``), and a replayed CUDA
   graph of it;
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
   card against CPU, each epoch's loss means to 1e-3; SP-SEDT's patch crop
   (``extract_patches_device``) on the card against the CPU to 1e-5, two
   tiny SP-SEDT train steps (resnet18, d 64, 1+1 layers, feature
   reconstruction, every patch query kept, dropout 0) card against CPU to
   1e-3; two tiny semi steps (2 strong, 2 weak, 4 unlabeled clips, a fixed
   student view, thresholds under every score) and the tiny semi trainer
   ``run_semi`` (2 epochs from a teacher checkpoint that favours one class,
   lr 1e-5) card against CPU: the pseudo counts exactly and above 0, the
   losses, the student and the teacher, the loss means, the adapted
   thresholds and F1 to 1e-3; two tiny audio-tag updates (resnet18, 128 x
   64, batch 4) and the tiny audio-tag trainer ``run_audio_tag`` (16
   synthetic clips, 2 epochs) card against CPU: the losses, the loss means
   and F1 to 1e-3; each update's change of every parameter equal to optax's
   clip and Adam from the device's own gradients to 1e-3 of the lr, and the
   changes card against CPU to 1e-2 of the lr on nine entries in ten or
   more; every parameter moved (the stem and ``layer1`` too), no K1-K4
   launched;
4. drives the flagship URBAN-SED evaluation step (10 s clips, batch 64)
   through ``build_model`` and ``make_eval_step``, with K1's launch count;
4b. drives the flagship supervised train step at batch 64 (``bench_torch``'s
   configuration and synthetic batch; dropout 0.1, bf16 autocast over f32
   parameters) through ``init_train_state`` and ``make_train_step``: K1 must
   launch once per step and K4 never (by the launch counters, which a
   replayed step moves by its capture's count, and by the K1 kernels in the
   profiler's window of replayed steps); every loss finite, the trainable
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
   finite, the final test of each strategy, the feature bank in use, the
   step's CUDA graph kept through the validations (only epoch 0 and the
   fine-tune's first epoch warm up and capture), each
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
4e. drives SP-SEDT's bare train step at the README's pretrain command
   (``SPSEDT_RECIPE``: ResNet-50 DC5, 6+3 layers, d 256, 20 queries from 10
   patches of 128 x 64, feature reconstruction, 496 x 64 DCASE clips,
   dropout 0.1, bf16 autocast, lr_backbone 0) at the reference's pretrain
   batch of 200 (2,000 crops a step, cut on the card from the target boxes)
   through ``train_lib.spsedt_config`` and ``make_train_step``: K1 must
   launch once a step at [600, 20, 20] and K2-K4 never; the frozen leaves,
   the lr-0 backbone leaves and every FrozenBN buffer unchanged bit for bit;
   it prints ms/step and clips/s, the peak memory, the busy and idle share
   under the profiler (``chiprun_out/spsedt_step_profile.txt``), the FLOP
   share of the bf16 peak, the patch crop's device time and K1's time on the
   step's own cost;
4e'. runs the graphed train step (``engine.StepGraphs``) against the eager
   one at both SEDT cells' widths, batch 32, 8 steps from the same weights,
   generator and batches with the lr cut tenfold from update 4: 1 eager
   call, 1 capture, 7 replays, K1 once a step, the dropout masks the eager
   run's, the losses, trained leaves and AdamW's moments within 4 times
   two eager runs' gap (bit for bit where those agree bit for bit); then
   evaluations of the model after the third call and after three replays
   more, each against a fresh copy's (the folded weights of the trained
   convolutions, which a replay writes unseen, must not be stale);
4f. drives the DCASE chain audio tags -> pretrain -> fine-tune -> semi at
   full width on disk: it writes a seeded DCASE layout (``SPSEDT_CLIPS``: 400
   unlabeled clips and 64 of each other split, cut from DCASE 2019's sizes),
   runs ``run_audio_tag`` at the README's AT command (``AT_CHAIN``: batch 64
   on the 64 weak and 64 synthetic clips, 2 epochs of 2 steps, validation on
   64 clips, the ``.npy`` cache and the ``_at`` scaler built on the run;
   K1-K4 none; the best checkpoint ``at_avg_dcase`` loads back), then
   ``run_spsedt --pretrain at_avg_dcase`` on the unlabeled clips (the recipe
   at batch 200, 2 epochs of 2 steps, a checkpoint every epoch; K1 exactly
   4 launches, K2-K4 none), checking the backbone surgery leaf for leaf
   (every backbone parameter the audio-tag checkpoint's bit for bit, every
   FrozenBN buffer its value before the load, no ``fc1``/``fc2`` key), then
   ``run_supervised --dec_at
   --pretrain <that checkpoint>`` for 1 epoch at batch 32 with strategies
   1-3 (K1 4 + 14 launches), checking the surgery leaf for leaf (every
   loaded parameter the checkpoint's, the class heads and query row 0 their
   own, encoder layers 3-5 of the pretrain without a home, the FrozenBN
   buffers untouched), then the semi stage, ``run_semi`` at the README's
   semi command from the fine-tune's best checkpoint (batch 64 = 16 strong +
   16 weak + 32 unlabeled, 4 steps an epoch, 2 epochs, a checkpoint every
   epoch; K1 8 + 4 launches, K2-K4 none; the final test on the best
   teacher; every checkpoint loads back); it prints the writing, the
   extraction and the scaler, per epoch ms/step and the data wait, the
   audio-tag validation's time and F1, the pseudo counts and thresholds,
   and the checkpoint I/O;
4g. drives the semi step at the README's semi command (``SEMI_RECIPE``:
   ResNet-50 DC5, 3+3 layers, d 256, 20 queries, ``dec_at``, focal loss,
   mixup 0.6, frequency mask and shift; dropout 0.1, bf16 autocast;
   496 x 64, batch 64 = 16 strong + 16 weak + 32 unlabeled; class-wise
   thresholds at 0.05, so that the random teacher labels every unlabeled
   clip) through ``train_lib.semi_views`` and ``make_semi_train_step``: K1
   must launch once a step at [192, 20, 20] (the labeled and pseudo-labeled
   problems of the three decoder layers) and K2-K4 never; the teacher after
   a step with the EMA within 1e-6 of d * e + (1 - d) * p, unchanged
   without it; the student's frozen leaves and the FrozenBN buffers bit for
   bit; some mixed head rows' pseudo targets carrying labeled events; it
   prints ms/step and clips/s, the pseudo counts, the peak memory, the
   FLOP share of the bf16 peak, the idle share under the profiler
   (``chiprun_out/semi_step_profile.txt``), the device time of the step's
   parts and K1's time on the step's own cost;
4h. drives the audio-tag step at the README's AT command (``AT_RECIPE`` at
   the parser's defaults: ResNet-50 DC5, 496 x 64, batch 64, 10 classes, fc
   2048 -> 1000 -> 10, f32 with cuDNN's default TF32 convolutions, lr 1e-4,
   clip 0.1) through ``train_lib.init_audio_tag_model``,
   ``make_audio_tag_optimizer`` and ``make_audio_tag_step``: K1-K4 never;
   every loss finite, every parameter moved, the FrozenBN buffers bit for
   bit; it prints ms/step and clips/s, the FLOPs a step and their share of
   the dense TF32 (or f32) peak, the peak memory, the busy and idle share
   and launches a step under the profiler (its table in the output
   directory as ``at_step_profile.txt``), the time by kernel kind and the
   device time of the forward, the backward and the clip with Adam;
4h'. drives AST's audio-tag step (``AST_RECIPE``: the published AudioSet
   model, bf16 autocast, AST's Adam) at batch 64 through
   ``train_lib.audio_tag_ast``, ``init_audio_tag_model``,
   ``make_ast_optimizer`` and ``make_audio_tag_step``: K4 12 times a step,
   every launch the tensor-core variant, one backward kernel call for each
   and no recompute (the count of K4's backward in the ``kernels`` line),
   every loss finite; it prints ms/step, clips/s and the peak memory;
4i. drives the flagship train step under ``torch.distributed``
   (``parallel/dryrun.py``; dropout 0, augment off, bench_torch's batch of
   64, bf16 autocast, 3 steps): (a) under DDP in a group of one over NCCL
   against the same steps without a group, losses and parameters to 1e-6
   (bit for bit where they are), and both timed (DDP's cost at one rank);
   (b) over two ranks on this one card over gloo (NCCL refuses two ranks on
   one device), 32 clips a rank, spawned by
   ``torch.multiprocessing.spawn``, against (a)'s steps without a group:
   the first step's global loss to 1e-5 and Adam's first update to 1e-3 of
   the lr on the entries both gradients pin (at least half of them under
   bf16), the later losses to 1e-2, the ranks' parameters bit for bit after
   every step, K1 once a step on each rank at [96, 10, 20]; it prints
   ms/step and one all_reduce of the gradients alone beside it; a sharded
   feature bank of 256 clips at 500 x 64 gathered at a global batch of 64
   on both ranks, rows equal to the dataset's, and timed; (c) the dryrun's
   five tiny legs over the same two ranks against one process, to the CPU
   tests' tolerances; a rank's failure fails the run;
4j. drives the flagship train step under tensor parallel over the model
   axis (``parallel/mesh.shard_model``: the attention heads and FFN hidden
   units cut over the model ranks, ``parallel/tensor.py``'s all_reduces):
   (a) at (1 x 2) ranks on this card over gloo (bench_torch's batch of 64,
   bf16 autocast, dropout 0.1, 3 steps) against the same steps in one
   process from the same seed: the first step's loss to 1e-3 relative, its
   gradients (gathered whole) to 0.1 of their leaf's largest, the later
   losses to 1e-2, the replicated parameters bit for bit on both ranks
   after every step, K1 once a step on each rank at [192, 10, 20]; it
   prints ms/step and the share of the step spent in the tensor-parallel
   all_reduces (CUDA events around each); Adam's first update within 1e-3
   of the lr on at least 40 % of the entries, those both gradients pin;
   then again in f32 (batch 32, 2 steps, TF32 off) at the CPU tests'
   tolerances, and that one-process f32 step again, and again with its
   features one ulp up (the gradients' move, FFN ReLUs that change sign,
   printed); (d) the same bf16 steps at (2 x 2) ranks, 32 clips a data
   rank, against (2 x 1) ranks, which draw the same dropout masks (each
   data rank its own), to (a)'s bf16 bounds, K1 once a step on each of the
   4 ranks at [96, 10, 20]; (b) the dryrun's five tiny legs at (2 x 2)
   ranks on this card over gloo against one process, to the CPU tests'
   tolerances (TF32 off); (c) layouts the port cannot run (heads that do
   not divide, a grid that does not fill the world) raise before any step;
4k. drives the measuring tools (``tools/*_torch.py``) at their JAX
   counterparts' geometries, a few iterations each: ``profile_step_torch``'s
   nine rows of the flagship step (bf16, batch 64; each row by CUDA events
   and by device time under the profiler; ``matcher_batch`` is K1 on the
   step's own cost in a replayed CUDA graph) and its ``--step_only`` at the
   tool's default f32; ``capture_trace_torch`` with
   ``trace_report_torch``'s table of the flagship step (3 traced steps), the
   semi step and the SP-SEDT step (2 each); ``profile_semi_torch`` (6+6
   layers, batch 64, with the teacher / pseudo-label / remainder split);
   ``profile_spsedt_torch`` (6+6 layers, batch 200); ``bench_spsedt_bank_torch``
   (batch 200, 8 steps a loop, the host-collated loop against the bank's);
   ``try_remat_torch`` (each variant's first f32 step against the
   baseline's, then the four variants timed in bf16).  Every row finite and
   positive; K1 once per step (or per call of a row that solves the
   matching) and K2-K4 never; each trace lists ``jv_warp_kernel`` once per
   traced step under ``hand-written``, and each trace's device total a step
   lies within 15 % of ``busy_ms`` of the same step; the bank loops'
   losses equal; every remat variant's loss within 1e-5 of the baseline's,
   its gradients within 1e-3 of each leaf's largest and the generator's
   state after the step the same;
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
   its plain version (and K4's backward at AST's [64, 12, 1214, 64] beside
   its bound, the plain backward and ``scaled_dot_product_attention``'s
   backward), computes its bound from bytes and operations, prints a
   second figure beside it on a line of its own (K1-K3: a model of the
   longest search's dependent steps, counted by hand from the source and
   priced at step latencies timed on the card, with the cycles an expansion
   really took; K4: its exponentials at an assumed special-function rate),
   times K1 also at every shape of ``K1_SHAPES`` on seeded costs, and for K4
   times the library call ``F.scaled_dot_product_attention``;
8. profiles the 10 s evaluation step, the train step, a trainer epoch, the
   SP-SEDT step, the semi step, the audio-tag step and the long predict
   into the output directory.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA device.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import flagship_config, synthetic_batch
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.cli import at_args, sedt_args, semi_args, spsedt_args
from sound_event_detection_transformer_tpu_torch.config import MeshConfig, SEDTConfig
from sound_event_detection_transformer_tpu_torch.data import wav_dataset
from sound_event_detection_transformer_tpu_torch.data.dataset import batch_iterator, collate, collate_weak
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder, ManyHotEncoder
from sound_event_detection_transformer_tpu_torch.data.feature_bank import FeatureBank
from sound_event_detection_transformer_tpu_torch.data.scaler import Scaler
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset
from sound_event_detection_transformer_tpu_torch.data.transforms import get_random_patch_boxes
from sound_event_detection_transformer_tpu_torch.engine import (
    Batch,
    get_pseudo_labels,
    init_train_state,
    make_eval_step,
    make_loss_fn,
    make_semi_train_step,
    make_teacher,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import (
    AudioTagBackbone,
    build_model,
    postprocess,
    set_criterion,
    total_loss,
)
from sound_event_detection_transformer_tpu_torch.models import transformer
from sound_event_detection_transformer_tpu_torch.models.criterion import DenseTargets
from sound_event_detection_transformer_tpu_torch.models.torch_import import (
    torchvision_resnet_shapes,
    torchvision_to_backbone,
)
from sound_event_detection_transformer_tpu_torch.ops import (
    _build,
    attention,
    augment,
    flash_attention,
    hungarian,
    matcher,
)
from sound_event_detection_transformer_tpu_torch.ops.frontend import make_frontend_fn
from sound_event_detection_transformer_tpu_torch.ops.patches import extract_patches_device
from sound_event_detection_transformer_tpu_torch.parallel import dryrun
from sound_event_detection_transformer_tpu_torch.parallel.distribute import (
    init_distributed,
    layout_shape,
)
from sound_event_detection_transformer_tpu_torch.parallel.mesh import shard_model
from sound_event_detection_transformer_tpu_torch.parallel.optim import (
    make_ast_optimizer,
    make_audio_tag_optimizer,
    param_label,
)
from sound_event_detection_transformer_tpu_torch.predict_cli import make_infer
from sound_event_detection_transformer_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from sound_event_detection_transformer_tpu_torch.utils.profiler import (
    busy_ms,
    card_line,
    cuda_ms,
    device_ms,
    Recording,
    kernel_kinds,
    measure,
    record,
    trace_table,
)

sys.path.append(str(Path(__file__).resolve().parent / "tools"))  # the measuring tools
import bench_spsedt_bank_torch  # noqa: E402
import capture_trace_torch  # noqa: E402
import profile_semi_torch  # noqa: E402
import profile_spsedt_torch  # noqa: E402
import profile_step_torch  # noqa: E402
import trace_report_torch  # noqa: E402
import try_remat_torch  # noqa: E402
from profile_step_torch import with_lsap_costs  # noqa: E402

# One H100 SXM at its 700 W limit (NVIDIA data sheet): device memory rate, the
# f32 rate outside the tensor cores (the type the Hungarian kernels compute
# in) and the tensor cores' dense bf16 rate (the type K4's inputs have).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # the tensor cores' dense TF32 rate (f32 convolutions under cuDNN's TF32)
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
# SP-SEDT: the README's pretrain command (ResNet-50 DC5, 6+3 layers, 20
# queries from 10 patches, feature reconstruction; 496 x 64 DCASE clips) at
# the reference's pretrain batch of 200; then the chain pretrain -> fine-tune
# on a seeded DCASE layout (400 unlabeled clips, 64 of each other split, cut
# from DCASE 2019's 14,412 / 2,045 / 1,578 / 1,168 / 692)
SPSEDT_RECIPE = ["--dataname", "dcase", "--feature_recon", "--num_patches", "10",
                 "--num_queries", "20", "--enc_layers", "6", "--batch_size", "200", "--log"]
SPSEDT_WARMUP = 3  # recipe steps before the timed ones
# the graphed step against the eager one (phase 4e'): steps at each SEDT
# cell's widths, the lr cut tenfold from update GRAPH_LR_DROP_AT on
GRAPH_STEPS = 8
GRAPH_BATCH = 32
GRAPH_LR_DROP_AT = 4
# the graphed run may lie this many times farther from the eager run than a
# second eager run does (``run_gap``): bit for bit where two eager runs agree
# bit for bit, as both cells' widths did on the H100
GRAPH_GAP_FACTOR = 4.0
# an evaluation between the graphed step's replays may lie this share of the
# move between two evaluations from a fresh copy's (phase 4e'); the folds
# are formed alike, so any gap is the convolutions' own
EVAL_FOLD_SHARE = 0.01
SPSEDT_STEPS = 5  # timed recipe steps
SPSEDT_ROOT = "build/chip_spsedt_data"
SPSEDT_EXP = "build/chip_spsedt_exp"
SPSEDT_CLIPS = {"unlabel": 400, "strong": 64, "weak": 64, "validate": 64, "test": 64}
SPSEDT_CHAIN = SPSEDT_RECIPE + ["--data_root", SPSEDT_ROOT, "--exp_root", SPSEDT_EXP,
                                "--epochs", "2", "--checkpoint_epochs", "1"]
FINE_TUNE_CHAIN = ["--dataname", "dcase", "--data_root", SPSEDT_ROOT, "--exp_root", SPSEDT_EXP,
                   "--dec_at", "--batch_size", "32", "--epochs", "1", "--fusion_strategy", "1",
                   "2", "3", "--log"]
# the semi trainer: the README's semi command (``train_ss_sedt.py --dataname
# dcase --dec_at --focal_loss --mix_up_ratio 0.6 --freq_mask --freq_shift``:
# ResNet-50 DC5, 3+3 layers, 20 queries, 496 x 64) at its semi batch of 64
# (16 strong, 16 weak, 32 unlabeled); the bare step's class-wise thresholds
# sit low enough that random weights (class scores near 1/11) give pseudo
# events.  Then the chain's semi stage on phase 4f's DCASE layout from the
# fine-tune's best checkpoint, and the tiny semi trainer card against CPU
# (lr 1e-5: at 1e-4 the tiny run amplifies a 1e-6 difference of its weights
# to 1.7e-3 of a loss mean within two epochs)
SEMI_RECIPE = ["--dataname", "dcase", "--dec_at", "--focal_loss", "--mix_up_ratio", "0.6",
               "--freq_mask", "--freq_shift", "--log"]
SEMI_WARMUP = 3  # recipe steps before the timed ones
SEMI_STEPS = 10  # timed recipe steps
SEMI_THRESHOLD = 0.05
SEMI_CHAIN = SEMI_RECIPE + ["--data_root", SPSEDT_ROOT, "--exp_root", SPSEDT_EXP, "--epochs", "2",
                            "--checkpoint_epochs", "1"]
TINY_SEMI = ["--dataname", "dcase", "--synthetic_smoke", "--smoke_clips", "16",
             "--semi_batch_size", "8", "--backbone", "resnet18", "--hidden_dim", "64",
             "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward", "128",
             "--num_queries", "6", "--epochs", "2", "--dropout", "0", "--compute_dtype",
             "float32", "--dec_at", "--lr", "1e-5", "--lr_backbone", "1e-5", "--log", "--info",
             "tiny_semi", "--teacher_model", "teacher"]
# the audio-tag trainer: the README's AT command (``train_at.py --dataname
# dcase --pooling avg``: ResNet-50 DC5, 496 x 64, batch 64, 10 classes, fc
# 2048 -> 1000 -> 10, f32, lr 1e-4, clip 0.1) at the parser's defaults, no
# cut; then the chain's first stage on phase 4f's DCASE layout (64 weak + 64
# synthetic clips: 2 steps an epoch, 2 epochs, one validation batch of 64);
# and the tiny trainer (resnet18, 16 clips, 2 epochs) card against CPU
AT_RECIPE = ["--dataname", "dcase", "--pooling", "avg", "--log"]
AT_WARMUP = 3  # recipe steps before the timed ones
AT_STEPS = 10  # timed recipe steps
AST_RECIPE = ["--at_model", "ast", "--synthetic_smoke", "--compute_dtype", "bfloat16"]
AST_STEPS = 3  # timed AST steps, after one that warms up
AT_CHAIN = AT_RECIPE + ["--data_root", SPSEDT_ROOT, "--exp_root", SPSEDT_EXP, "--epochs", "2"]
TINY_AT = ["--dataname", "dcase", "--synthetic_smoke", "--smoke_clips", "16", "--batch_size",
           "4", "--backbone", "resnet18", "--epochs", "2", "--log", "--exp_root"]
SOURCE_DIR = "sound_event_detection_transformer_tpu_torch/csrc/"
PALLAS_DIR = "sound_event_detection_transformer_tpu/ops/pallas/"


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
            if name.startswith("launches") or name == "backward_launches":
                setattr(wrapper, name, 0)


# K1's kernel on the device's timeline (``benchmark/metrics/k1_roofline.py``'s
# pattern): ``jv_warp_kernel<1>``
K1_KERNEL = re.compile(r"jv_warp_kernel<\s*1\s*[,>]")


def traced_k1(rec: Recording) -> float:
    """K1's kernels a call in a profiled window (``utils.profiler.record``),
    as the device ran them: where the calls replay a CUDA graph, the launch
    counters only repeat what the capture moved them by."""
    return sum(n for k, _, n in rec.rows if K1_KERNEL.search(k)) / rec.calls


def launch_counts() -> dict:
    """Every wrapper's count, and under ``"K2 warp"``, ``"K4 tensor"`` and so
    on the counts of the variants that K2, K3 and K4 dispatch between."""
    k2, k3, k4 = hungarian.lsap_block, hungarian.lsap_square, flash_attention.flash_attention
    return {"K1": hungarian.lsap_lane.launches, "K2": k2.launches,
            "K3": k3.launches, "K4": k4.launches,
            "K2 warp": k2.launches_warp, "K2 block": k2.launches_block,
            "K3 warp": k3.launches_warp, "K3 square": k3.launches_square,
            "K4 tensor": k4.launches_tensor, "K4 f32": k4.launches_f32,
            "K4 split": k4.launches_split, "K4 backward": k4.backward_launches}


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


AST_K4 = (64, 12, 1214, 64)  # AST's attention in the benchmark's cell: [B, H, N, D]
# K4's backward at its bf16 tensors, each gradient against the plain backward
# in f32 on the same inputs: the kernels round P and dS to bf16 once as
# operands of the products and the gradients to bf16 at the end (2^-9
# relative each), so the largest difference over the largest |gradient| stays
# at a few bf16 roundings (0.0061 the largest read on an H100)
K4_BACKWARD_TOL = 2e-2


def k4_backward_against_plain(q, k, v, bias, label: str) -> float:
    """K4's backward kernels (through autograd and called directly) against
    :func:`flash_attention.flash_attention_backward_plain` run in f32 on the
    same bf16 q, k, v and a seeded output gradient, each side from its own
    forward's output and row statistics.  Through autograd: one backward
    launch, no recompute, the same bits as the direct call.  Returns the
    largest of the three gradients' max |kernel - plain| / max |plain|."""
    gen = torch.Generator(device=q.device).manual_seed(q.shape[2] * 131 + k.shape[2])
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    counts = (flash_attention.flash_attention.backward_launches,
              flash_attention.flash_attention.recomputes)
    out = flash_attention.flash_attention(*leaves, bias)
    out.backward(g)
    torch.cuda.synchronize()
    took = (flash_attention.flash_attention.backward_launches - counts[0],
            flash_attention.flash_attention.recomputes - counts[1])
    assert took == (1, 0), f"K4 backward at {label}: (kernel calls, recomputes) {took}"
    got_out, stats, out_lo = flash_attention._launch(q, k, v, bias, with_stats=True)
    assert torch.equal(got_out, out), f"K4 at {label}: the stats' store moved the output"
    got = flash_attention.flash_attention_backward(q, k, v, bias, got_out, stats, g, out_lo)
    for name, a, t in zip("qkv", got, leaves):
        assert torch.equal(a, t.grad), f"K4 backward at {label}: d{name} through autograd differs"
    qf, kf, vf = q.float(), k.float(), v.float()
    lse = stats[..., 0] + stats[..., 1].log()
    scores = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    want_lse = torch.logsumexp(scores if bias is None else scores + bias, dim=-1)
    # each row's error over the larger of its own |log-sum-exp| and 1, so the
    # -1e9 of an all-padded clip's rows does not hide the live rows' errors
    lse_err = float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max())
    del scores, want_lse
    plain_out, plain_stats = flash_attention.flash_attention_plain(qf, kf, vf, bias,
                                                                   with_stats=True)
    want = flash_attention.flash_attention_backward_plain(qf, kf, vf, bias, plain_out,
                                                          plain_stats, g.float())
    errs = k4_backward_gaps(got, want, q.dtype, label)
    print(f"K4 backward parity {label}: max |kernel - plain| / max |plain| of dq, dk, dv "
          f"{errs[0]:.3g}, {errs[1]:.3g}, {errs[2]:.3g}; row log-sum-exp {lse_err:.3g}")
    if lse_err > 1e-5:
        raise AssertionError(f"K4 backward at {label}: row log-sum-exp off by {lse_err}")
    return max(errs)


def k4_backward_gaps(got, want, dtype, label: str) -> list:
    """max |kernel - plain| / max |plain| of each of dq, dk and dv, the
    kernel's in ``dtype`` and finite; raises above ``K4_BACKWARD_TOL``."""
    errs = []
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and torch.isfinite(a).all().item(), (label, name)
        errs.append(float((a.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    if max(errs) > K4_BACKWARD_TOL:
        raise AssertionError(f"K4 backward parity failed at {label}: dq, dk, dv {errs}")
    return errs


def k4_backward_bound(b: int, h: int, n: int, d: int) -> dict:
    """The least time of K4's backward at [B, H, N, D] without a bias: five
    products of 2 B H N^2 D at the bf16 rate, against q, k, v, o and dout read
    and dq, dk, dv written in bf16 and the row statistics and D in f32.  The
    benchmark's ``metrics/k4_backward_roofline.least_s`` counts the same: the
    two must stay equal."""
    ops = 5 * 2 * b * h * n * n * d
    nbytes = 8 * b * h * n * d * 2 + 2 * b * h * n * 4
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return {"ms": max(bytes_ms, ops_ms), "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms}


def time_k4_backward(dev, card: str, shape=AST_K4) -> dict:
    """K4's backward kernels at AST's [B, H, N, D] in bf16 on tensors laid out
    as the model's projections lay them, in a replayed CUDA graph; beside it
    its bound, the plain backward's time and, as ``library_ms`` only,
    ``scaled_dot_product_attention``'s backward (which the port never calls).
    The kernels' gradients are held against the plain backward's on the same
    inputs to ``K4_BACKWARD_TOL``."""
    b, h, n, d = shape
    rng = np.random.RandomState(SEED + 2)
    q, k, v, _ = attention_inputs(rng, b, h, n, n, d, torch.bfloat16, dev, "none",
                                  projected=True)
    out, stats, out_lo = flash_attention._launch(q, k, v, None, with_stats=True)
    g = torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32)).to(dev, q.dtype).transpose(1, 2)
    call = lambda: flash_attention.flash_attention_backward(q, k, v, None, out, stats, g, out_lo)
    ms = device_ms(call, calls=5, replays=4)
    eager_ms = cuda_ms(call, 10)
    qf, kf, vf = q.float(), k.float(), v.float()
    plain_out, plain_stats = flash_attention.flash_attention_plain(qf, kf, vf, None,
                                                                   with_stats=True)
    plain = lambda: flash_attention.flash_attention_backward_plain(
        qf, kf, vf, None, plain_out, plain_stats, g.float())
    plain_ms = cuda_ms(plain, 2, warmup=1)
    label = f"{list(shape)} bf16 none, projected, timed"
    errs = k4_backward_gaps(call(), plain(), q.dtype, label)
    print(f"K4 backward parity {label}: max |kernel - plain| / max |plain| of dq, dk, dv "
          f"{errs[0]:.3g}, {errs[1]:.3g}, {errs[2]:.3g}")
    del qf, kf, vf, plain_out, plain_stats
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True), 10)
    forward_ms = device_ms(lambda: flash_attention.flash_attention(q, k, v), calls=5, replays=4)
    bound = k4_backward_bound(b, h, n, d)
    print(f"K4 backward q k v {list(q.shape)} bf16: {ms:.4f} ms on the device "
          f"({eager_ms:.4f} ms per call launched back to back from Python; forward "
          f"{forward_ms:.4f} ms), plain backward {plain_ms:.2f} ms, library backward "
          f"(scaled_dot_product_attention, not on the port's path) {library_ms:.4f} ms, bound "
          f"{bound['ms']:.4f} ms by {bound['by']} ({bound['ops']} operations in "
          f"{bound['ops_ms']:.4f} ms; {bound['bytes']} B in {bound['bytes_ms']:.4f} ms), "
          f"{100 * bound['ms'] / ms:.1f} % of it ({card})")
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["by"], "library_ms": library_ms, "forward_ms": forward_ms,
            "max_rel_err_timed": max(errs)}


# K4's backward at the tensor-core variant's edges: (B, H, Sq, Sk, D, the
# forward splits the keys); test_k4_tensor_core_variant's shapes and a slice
# of AST's batch
K4_BACKWARD_SHAPES = [
    (8, 8, 752, 752, 32, False), (8, 8, 41, 752, 32, True), (2, 2, 1, 752, 32, True),
    (2, 2, 16, 40, 32, False), (2, 2, 17, 100, 64, True), (1, 2, 41, 200, 128, True),
    (2, 4, 41, 130, 64, True), (3, 2, 16, 65, 32, True), (2, 2, 300, 190, 128, True),
    (8, 8, 300, 70, 64, False), (2, 12, 1214, 1214, 64, False)]


def check_k4_backward(dev: torch.device) -> float:
    """K4's backward kernels against the plain backward at every shape of
    ``K4_BACKWARD_SHAPES`` with every constant bias kind (q, k, v laid out as
    the projections lay them with the padding bias), then at AST's whole
    ``AST_K4`` as its training step calls them (no bias, the projections'
    layout), and a captured call replayed to the same bits; returns the
    largest relative difference."""
    rng = np.random.RandomState(SEED + 3)
    worst = 0.0
    for b, h, sq, sk, d, _ in K4_BACKWARD_SHAPES:
        for bias_kind in ("padding", "full", "none"):
            q, k, v, bias = attention_inputs(rng, b, h, sq, sk, d, torch.bfloat16, dev, bias_kind,
                                             projected=bias_kind == "padding")
            worst = max(worst, k4_backward_against_plain(q, k, v, bias,
                                                         f"{(b, h, sq, sk, d)} bf16 {bias_kind}"))
    b, h, n, d = AST_K4
    q, k, v, _ = attention_inputs(rng, b, h, n, n, d, torch.bfloat16, dev, "none", projected=True)
    worst = max(worst, k4_backward_against_plain(q, k, v, None,
                                                 f"AST {list(AST_K4)} bf16 none, projected"))
    del q, k, v
    q, k, v, bias = attention_inputs(rng, 2, 4, 41, 752, 32, torch.bfloat16, dev, "padding",
                                     projected=True)
    out, stats, out_lo = flash_attention._launch(q, k, v, bias, with_stats=True)
    g = torch.randn(q.shape, device=dev).to(q.dtype)
    want = flash_attention.flash_attention_backward(q, k, v, bias, out, stats, g, out_lo)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = flash_attention.flash_attention_backward(q, k, v, bias, out, stats, g, out_lo)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want)), "K4 backward under a CUDA graph"
    print(f"K4 backward parity: ok at {len(K4_BACKWARD_SHAPES)} shapes x 3 bias kinds and AST's "
          f"{list(AST_K4)}, largest "
          f"{worst:.3g} of the plain gradient's largest; a replayed CUDA graph gives the same bits")
    return worst


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
    errs["K4 backward"] = check_k4_backward(dev)
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
    CPU (where K1 is its plain version); see ``train_steps_against_cpu``."""
    cfg = tiny_train_config()
    _, batches = make_batches(cfg, 4, 1, seed)
    return train_steps_against_cpu(cfg, batches[0], dev, seed, steps)


def train_steps_against_cpu(cfg: SEDTConfig, batch, dev: torch.device, seed: int,
                            steps: int) -> float:
    """``steps`` train steps of ``cfg`` on ``batch`` on the card against the
    same steps on the CPU, from the same weights, TF32 off: the losses and
    every parameter after each step to 1e-3.  Returns the largest
    difference."""
    runs = {}
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, wd = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
            state = init_train_state(model, cfg, steps_per_epoch=10)
            step = make_train_step(model, wd, cfg, state.optimizer, device=d)
            gen = torch.Generator(device=d).manual_seed(seed)
            runs[d.type] = []
            for _ in range(steps):
                metrics = step(batch, gen)
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


def counted_launches(call) -> tuple:
    """``call()`` with K1's launches counted apart in eval steps
    (``train_lib.evaluate``) and elsewhere, and every LSAP cost kept:
    (what ``call`` returns, K1 in train steps, K1 in eval steps, all counts,
    costs).  Resets the counts first: the main path's counts."""
    eval_launches = []
    real_evaluate = train_lib.evaluate

    def evaluate(*a, **kw):
        before = hungarian.lsap_lane.launches
        out = real_evaluate(*a, **kw)
        eval_launches.append(hungarian.lsap_lane.launches - before)
        return out

    train_lib.evaluate = evaluate
    try:
        reset_launch_counts()  # the main path: counts from here ...
        out, costs = with_lsap_costs(call)
        counts = launch_counts()  # ... to here
    finally:
        train_lib.evaluate = real_evaluate
    k1_eval = sum(eval_launches)
    return out, counts["K1"] - k1_eval, k1_eval, counts, costs


def step_flops(model, wd, cfg: SEDTConfig, batch, gen) -> int:
    """The FLOPs of one train step as ``FlopCounterMode`` counts them on the
    port's own forward, criterion and backward (``make_loss_fn``: matrix
    products and convolutions, forward and backward; a replayed step runs
    no operator that a mode could count).  The gradients are zeroed after."""
    loss_fn = make_loss_fn(model, wd, cfg)
    boxes = batch.targets.boxes[:, :cfg.model.num_patches] if cfg.model.self_sup else None
    with FlopCounterMode(display=False) as counter:
        loss, _ = loss_fn(batch.feats, batch.pad_mask, batch.targets, batch.strong, batch.weak,
                          gen, boxes)
        loss.backward()
    model.zero_grad(set_to_none=False)
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
        losses.append(step(batch, gen)["loss"].clone())
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
    launches = counts["K1"]  # the main path's, for the kernels line
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
    flops = step_flops(model, wd, cfg, batch, gen)
    print(f"train step: {flops / 1e9:.1f} GFLOP a step counted by FlopCounterMode, "
          f"{flops / batch_size / 1e9:.2f} GFLOP a clip; at {event_ms:.3f} ms that is "
          f"{flops / (event_ms * 1e-3) / 1e12:.1f} TFLOP/s, {flops / (event_ms * 1e-3) / BF16_OPS_PER_S:.4f} "
          f"of the dense bf16 peak ({BF16_OPS_PER_S / 1e12:.0f} TFLOP/s) ({card})")
    rec = profile(lambda: step(batch, gen), "train step", card, "train_step_profile.txt")
    traced = traced_k1(rec)
    assert traced == 1, f"the replayed train step ran K1 {traced} times a step on the card"
    print(f"train step: K1 {traced:g} a replayed step in the profiler's window of {rec.calls} "
          f"({step.graph.counts()}; {card})")
    split_train_step(model, wd, cfg, state.optimizer, batch, gen, card)
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5, latency,
                     clock_hz)

    # the fine-tune stage: relaxed matching, lr fixed at 1e-5
    ft_state = init_train_state(model, cfg, steps_per_epoch=100, fixed_lr=1e-5)
    ft_step = make_train_step(model, wd, cfg, ft_state.optimizer, fine_tune=True, device=dev)
    _, costs = with_lsap_costs(lambda: ft_step(batch, gen))  # warm-up, its costs kept
    shapes = [list(c.shape) for c in costs]
    want = [[batch_size, m.num_queries, m.max_events],
            [(m.dec_layers - 1) * batch_size, m.num_queries, m.max_events]]
    assert shapes == want, shapes
    reset_launch_counts()  # the fine-tune path: counts from here ...
    ft = torch.stack([ft_step(batch, gen)["loss"].clone() for _ in range(FINE_TUNE_STEPS)]).cpu()
    counts = launch_counts()  # ... to here
    assert torch.isfinite(ft).all(), ft
    assert counts["K1"] == 2 * FINE_TUNE_STEPS and counts["K4"] == 0, counts
    ft_traced = traced_k1(record(lambda: ft_step(batch, gen)))
    assert ft_traced == 2, f"the replayed fine-tune step ran K1 {ft_traced} times a step"
    print(f"fine-tune step (lr 1e-5): losses {ft.tolist()}, K1 {counts['K1']} launches in "
          f"{FINE_TUNE_STEPS} steps at {shapes}, {ft_traced:g} a replayed step in the "
          f"profiler's window ({card})")

    # the DCASE recipe's augmentations, and a time mask
    aug_cfg = cfg.replace(augment=dataclasses.replace(
        cfg.augment, mix_up_ratio=0.6, time_mask=True, freq_mask=True, freq_shift=True))
    aug_step = make_train_step(model, wd, aug_cfg, state.optimizer, device=dev)
    reset_launch_counts()  # the augmented path: counts from here ...
    aug = torch.stack([aug_step(batch, gen)["loss"].clone() for _ in range(AUGMENT_STEPS)]).cpu()
    counts = launch_counts()  # ... to here
    assert torch.isfinite(aug).all() and counts["K1"] == AUGMENT_STEPS, (aug, counts)
    aug_traced = traced_k1(record(lambda: aug_step(batch, gen)))
    assert aug_traced == 1, f"the replayed augmented step ran K1 {aug_traced} times a step"
    print(f"augmented step (mixup 0.6, time and frequency masks, frequency shift): losses "
          f"{aug.tolist()}, K1 {counts['K1']} launches in {AUGMENT_STEPS} steps, "
          f"{aug_traced:g} a replayed step in the profiler's window ({card})")
    return {"launches": launches, "err": k1_err, "shape": list(cost.shape), "timing": timing}


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, k1_train, k1_eval, counts, costs = counted_launches(
        lambda: train_lib.run_supervised(args, device=dev))
    wall_s = time.perf_counter() - t0
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
    # the step's graph lasts through the validations: only the first plain
    # and the first fine-tune epoch (a new step) warm up and capture
    graphs = [e["graph"] for e in epochs]
    assert graphs == [(1, e["steps"] - 1, 1) if e["epoch"] in (0, args.epochs_ls)
                      else (0, e["steps"], 0) for e in epochs], graphs
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
              f"I/O {e.get('checkpoint_s', 0.0):.3f} s; F1 {e['val_f1']}; {e['graph'].line()} "
              f"({card})")
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
        profile(lambda: out.append(real_epoch(*a, **kw)), label, card, file_name, once=True)
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
    loaded = []
    real_init = train_lib._imagenet_backbone_init

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

    train_lib._imagenet_backbone_init = backbone_init
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        result, k1_train, k1_eval, counts, costs = counted_launches(
            lambda: train_lib.run_supervised(args, device=dev))
    finally:
        train_lib._imagenet_backbone_init = real_init
    peak = torch.cuda.max_memory_allocated(dev)
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


# --------------------------------------------------------------- audio tags


def at_batch(cfg: SEDTConfig, batch: int, seed: int) -> tuple:
    """``batch`` synthetic clips at the config's geometry with clip labels
    only, as (features [B, T, F, 1], multi-hot [B, C]) on the CPU."""
    m = cfg.model
    mhe = ManyHotEncoder(list(cfg.data.classes), n_frames=m.max_frames)
    ds = SyntheticDataset(batch, cfg.data.classes, m.max_frames, m.n_mels, mhe.encode_weak,
                          max_events=2, seed=seed, weak_only=True)
    return collate_weak([ds[i] for i in range(batch)])


def audio_tag_step(args, cfg: SEDTConfig, dev: torch.device) -> tuple:
    """(model, optimizer, step) of the audio-tag trainer for ``args`` on
    ``dev``, through the trainer's own functions."""
    model = train_lib.init_audio_tag_model(cfg, args.pooling, dev)
    optimizer = make_audio_tag_optimizer(model, args.lr, args.lr_drop, 100,
                                         train_lib.AT_CLIP_MAX_NORM)
    return model, optimizer, train_lib.make_audio_tag_step(model, optimizer)


def check_audio_tag_leaves(model, params: dict, buffers: dict) -> None:
    """After audio-tag updates: every parameter moved, the stem and
    ``layer1`` too (nothing is frozen), and every FrozenBN buffer is as it
    was, bit for bit."""
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), params[n])}
    assert moved == set(params), f"not moved: {sorted(set(params) - moved)}"
    assert {"backbone.conv0.weight", "backbone.conv1.weight",
            "backbone.layer1_0.conv1.weight"} <= moved
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), f"FrozenBN buffer {n} changed"


def audio_tag_updates(args, cfg: SEDTConfig, dev: torch.device, x: torch.Tensor,
                      y: torch.Tensor, steps: int) -> dict:
    """``steps`` audio-tag updates on ``dev`` from the seeded init, K1-K4
    asserted at no launch and the leaves checked: the losses, and the
    parameters before the first update and after each, and the gradients
    before each clip, all on the CPU."""
    model, optimizer, step = audio_tag_step(args, cfg, dev)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    out = {"losses": [], "params": [{n: p.cpu() for n, p in params.items()}], "grads": []}
    real_step = optimizer.step

    def step_keeping_grads():
        out["grads"].append({n: p.grad.cpu().clone() for n, p in model.named_parameters()})
        real_step()

    optimizer.step = step_keeping_grads
    reset_launch_counts()
    for _ in range(steps):
        out["losses"].append(float(step(x.to(dev), y.to(dev))))
        out["params"].append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
    counts = launch_counts()
    assert not any(counts.values()), f"the audio-tag step launched a kernel: {counts}"
    check_audio_tag_leaves(model, params, buffers)
    return out


def adam_deltas(grads: list, lr: float, max_norm: float) -> list:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))`` from the
    gradients of each update, in f64: each update's change of every leaf."""
    m = v = None
    deltas = []
    for k, g in enumerate(grads, 1):
        norm = math.sqrt(sum(float(t.double().square().sum()) for t in g.values()))
        scale = min(1.0, max_norm / norm)
        g = {n: t.double() * scale for n, t in g.items()}
        m = {n: 0.1 * t + (0.9 * m[n] if m else 0) for n, t in g.items()}
        v = {n: 0.001 * t.square() + (0.999 * v[n] if v else 0) for n, t in g.items()}
        deltas.append({n: -lr * (m[n] / (1 - 0.9 ** k))
                       / ((v[n] / (1 - 0.999 ** k)).sqrt() + 1e-8) for n in g})
    return deltas


def small_audio_tag_step(dev: torch.device, seed: int, steps: int = 2) -> float:
    """Two tiny audio-tag updates (``TINY_AT``: resnet18 on 128 x 64, batch 4,
    f32, lr 1e-4) on the card and on the CPU from the same weights, TF32 off.
    An Adam update moves an entry by about the lr whatever its gradient, so
    the parameters are held by their changes, in fractions of the lr:

    * each side's own: each update's change of every entry equals optax's
      clip and Adam from that side's gradients (``adam_deltas``) to 1e-3 of
      the lr and two roundings of the parameter; a wrong sign, lr, bias
      correction or skipped clip is off by more;
    * card against CPU: the losses and the gradients' norms to 1e-3; the
      change since the init, after each update, to 1e-2 of the lr on at
      least nine entries in ten (the rest are those whose gradients the two
      devices' summation orders move enough to matter, or flip in sign), and
      to Adam's bound, 2 lr an update, on every entry.

    On the card every parameter moved, the buffers bit for bit and K1-K4
    never launched.  Returns the largest loss difference."""
    args = at_args(TINY_AT + [TRAIN_ROOT + "_at"])
    cfg = train_lib.args_to_config(args)
    lr = args.lr
    x, y = at_batch(cfg, 4, seed)
    with cudnn_tf32_off():
        ref, got = (audio_tag_updates(args, cfg, d, x, y, steps)
                    for d in (torch.device("cpu"), dev))
    worst = 0.0
    for r, g in zip(ref["losses"], got["losses"], strict=True):
        assert math.isfinite(g) and abs(g - r) <= 1e-3 + 1e-3 * abs(r), (g, r)
        worst = max(worst, abs(g - r))
    ulp = torch.finfo(torch.float32).eps
    for side in (ref, got):
        for k, want in enumerate(adam_deltas(side["grads"], lr, train_lib.AT_CLIP_MAX_NORM)):
            before, after = side["params"][k], side["params"][k + 1]
            for n, d in want.items():
                off = ((after[n] - before[n]).double() - d).abs()
                tol = 1e-3 * lr + 2 * ulp * after[n].abs().double()
                assert (off <= tol).all(), (k, n, float((off - tol).max()) / lr)
    for k in range(steps):
        norms = [torch.linalg.vector_norm(torch.stack([t.norm() for t in side["grads"][k].values()]))
                 for side in (ref, got)]
        assert torch.allclose(norms[1], norms[0], rtol=1e-3), (k, norms)
    for k in range(1, steps + 1):
        n_close = n_all = 0
        for n, p0 in ref["params"][0].items():
            assert torch.equal(got["params"][0][n], p0), n  # the same init
            apart = (got["params"][k][n] - ref["params"][k][n]).abs() / lr
            assert (apart <= 2 * k + 1e-3).all(), (k, n, float(apart.max()))
            n_close += int((apart <= 1e-2).sum())
            n_all += apart.numel()
        assert n_close >= 0.9 * n_all, (k, n_close, n_all)
        print(f"tiny audio-tag step, update {k}: {n_close / n_all:.4f} of the entries' changes "
              f"agree card vs CPU to 1e-2 of the lr")
    return worst


def small_audio_tag_trainer(dev: torch.device) -> float:
    """``run_audio_tag`` at the tiny size (``TINY_AT``: 16 synthetic clips,
    2 epochs) on the card and on the CPU, TF32 off: each epoch's loss mean
    and validation F1 to 1e-3, the same best checkpoint.  Returns the largest
    difference."""
    runs = []  # the CPU's, then the card's
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            root = Path(TRAIN_ROOT + "_at_tiny") / d.type
            shutil.rmtree(root, ignore_errors=True)
            runs.append(train_lib.run_audio_tag(at_args(TINY_AT + [str(root)]), device=d))
    ref, got = runs
    worst = 0.0
    for r, g in zip(ref.epochs, got.epochs, strict=True):
        for key in ("loss", "f1"):
            assert np.isfinite(g[key]) and np.isclose(g[key], r[key], rtol=1e-3, atol=1e-3), (
                r["epoch"], key, g[key], r[key])
            worst = max(worst, abs(g[key] - r[key]))
    assert Path(got.checkpoint).name == Path(ref.checkpoint).name == "at_avg_dcase"
    print(f"tiny audio-tag trainer, card vs CPU: losses {[round(e['loss'], 5) for e in got.epochs]}"
          f", F1 {[round(e['f1'], 5) for e in got.epochs]}")
    return worst


def run_audio_tag_step_phase(dev: torch.device, card: str) -> dict:
    """Phase 4h: the audio-tag step at the README's AT command (``AT_RECIPE``
    at the parser's defaults: ResNet-50 DC5, 496 x 64, batch 64, 10 classes,
    fc 2048 -> 1000 -> 10, f32 with cuDNN's default TF32 convolutions, lr
    1e-4, clip 0.1) through ``init_audio_tag_model``,
    ``make_audio_tag_optimizer`` and ``make_audio_tag_step``, the batch on the
    card: K1-K4 never; every loss finite, every parameter moved, the FrozenBN
    buffers bit for bit.  Returns the launch counts of the timed steps."""
    args = at_args(AT_RECIPE)
    cfg = train_lib.args_to_config(args)
    m = cfg.model
    bs = cfg.data.batch_size
    model, optimizer, step = audio_tag_step(args, cfg, dev)
    x, y = (t.to(dev) for t in at_batch(cfg, bs, SEED))
    tf32 = torch.backends.cudnn.allow_tf32
    rate, rate_name = (TF32_OPS_PER_S, "TF32") if tf32 else (F32_OPS_PER_S, "f32")
    print(f"audio-tag step: {m.backbone} dilation={m.dilation} pooling {args.pooling}, fc "
          f"{model.fc1.in_features} -> {model.fc1.out_features} -> {model.fc2.out_features}, "
          f"input {m.max_frames}x{m.n_mels} batch {bs}, f32 (cuDNN allow_tf32 {tf32}, matmul "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}), lr {args.lr}, clip "
          f"{train_lib.AT_CLIP_MAX_NORM}, {sum(p.numel() for p in model.parameters())} parameters")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    for _ in range(AT_WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_launch_counts()  # the main path: counts from here ...
    losses = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(AT_STEPS):
        losses.append(step(x, y))
    stop.record()
    stop.synchronize()
    host_s = (time.perf_counter() - t0) / AT_STEPS
    counts = launch_counts()  # ... to here
    event_ms = start.elapsed_time(stop) / AT_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all(), losses
    assert not any(counts.values()), f"the audio-tag step must launch no K1-K4: {counts}"
    check_audio_tag_leaves(model, params, buffers)
    print(f"audio-tag step: {event_ms:.3f} ms/step by CUDA events, {bs / event_ms * 1e3:.1f} "
          f"clips/s; {host_s * 1e3:.3f} ms/step by the host clock; {AT_STEPS} steps, K1-K4 no "
          f"launch; losses {losses[0]:.4f} .. {losses[-1]:.4f}; all {len(params)} parameters "
          f"moved, {len(buffers)} FrozenBN buffers unchanged; peak memory {peak / 2**30:.3f} GiB "
          f"({card})")
    with FlopCounterMode(display=False) as counter:
        step(x, y)
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    print(f"audio-tag step: {flops / 1e9:.1f} GFLOP a step counted by FlopCounterMode, "
          f"{flops / bs / 1e9:.2f} GFLOP a clip; at {event_ms:.3f} ms that is "
          f"{flops / (event_ms * 1e-3) / 1e12:.1f} TFLOP/s, {flops / (event_ms * 1e-3) / rate:.4f} "
          f"of the dense {rate_name} peak ({rate / 1e12:.0f} TFLOP/s) ({card})")
    rec = profile(lambda: step(x, y), "audio-tag step", card, "at_step_profile.txt")
    for kind, (ms, n) in kernel_kinds(rec.rows, rec.calls).items():
        print(f"audio-tag step kernels {kind}: {ms:.4f} ms in {n} launches a step ({card})")
    loss_fn = lambda: F.binary_cross_entropy_with_logits(model(x), y)
    parts = {"forward and loss": busy_ms(loss_fn)}
    parts["backward"] = busy_ms(lambda: loss_fn().backward()) - parts["forward and loss"]
    parts["clip and Adam"] = busy_ms(optimizer.step)
    total = sum(parts.values())
    for name, ms in parts.items():
        print(f"audio-tag step part {name}: {ms:.4f} ms of device time, {ms / total:.4f} of the "
              f"parts' {total:.3f} ms ({card})")
    return counts


def run_ast_step_phase(dev: torch.device, card: str) -> dict:
    """Phase 4h': AST's audio-tag step (``AST_RECIPE``: the published
    AudioSet model, 1,214 tokens, d 768, 12 heads, 12 layers, bf16 autocast,
    AST's Adam) through ``audio_tag_ast``, ``init_audio_tag_model``,
    ``make_ast_optimizer`` and ``make_audio_tag_step`` at batch ``AST_K4[0]``
    on seeded clips on the card: K4 12 times a step, every launch the
    tensor-core variant unsplit, one backward kernel call for each launch and
    no recompute, K1-K3 never, every loss finite.  Returns the launch counts
    of the timed steps."""
    args = at_args(AST_RECIPE + ["--batch_size", str(AST_K4[0])])
    cfg, ast = train_lib.audio_tag_ast(args, train_lib.args_to_config(args))
    bs = cfg.data.batch_size
    model = train_lib.init_audio_tag_model(cfg, args.pooling, dev, ast)
    step = train_lib.make_audio_tag_step(model, make_ast_optimizer(model, args.lr, AST_STEPS),
                                         compute_dtype=train_lib.audio_tag_dtype(cfg, ast))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(bs, ast.frames, ast.n_mels, 1, generator=gen, device=dev)
    y = (torch.rand(bs, ast.num_classes, generator=gen, device=dev) < 0.01).float()
    step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    recomputes = flash_attention.flash_attention.recomputes
    reset_launch_counts()  # the main path: counts from here ...
    losses = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(AST_STEPS):
        losses.append(step(x, y))
    stop.record()
    stop.synchronize()
    counts = launch_counts()  # ... to here
    recomputes = flash_attention.flash_attention.recomputes - recomputes
    event_ms = start.elapsed_time(stop) / AST_STEPS
    losses = torch.stack(losses).float().cpu()
    assert torch.isfinite(losses).all(), losses
    want = ast.layers * AST_STEPS
    assert counts["K4"] == counts["K4 tensor"] == counts["K4 backward"] == want, counts
    assert counts["K4 split"] == 0 and recomputes == 0, (counts, recomputes)
    assert not any(counts[key] for key in counts if not key.startswith("K4")), counts
    print(f"AST step: {ast.tokens} tokens, d {ast.dim}, {ast.heads} heads, {ast.layers} layers, "
          f"batch {bs}, {train_lib.audio_tag_dtype(cfg, ast)} autocast: {event_ms:.3f} ms/step "
          f"by CUDA events, {bs / event_ms * 1e3:.1f} clips/s; in {AST_STEPS} steps K4 "
          f"{counts['K4']} launches (tensor-core variant {counts['K4 tensor']}, unsplit), "
          f"{counts['K4 backward']} backward kernel calls, {recomputes} recomputes; losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB ({card})")
    return counts


def run_audio_tag_chain(dev: torch.device, card: str) -> dict:
    """The chain's audio-tag stage (phase 4f, first): ``run_audio_tag`` at
    ``AT_RECIPE``'s width on the phase's DCASE layout (64 weak + 64 synthetic
    training clips at batch 64: 2 steps an epoch, 2 epochs; 64 validation
    clips in one batch), the ``.npy`` cache and the scaler built on the run:
    K1-K4 never; every epoch's loss finite; the best checkpoint
    ``at_avg_dcase`` loads back into the model.  Returns its name and the
    launch counts."""
    args = at_args(AT_CHAIN)
    t0 = time.perf_counter()
    res, _, _, counts, _ = counted_launches(lambda: train_lib.run_audio_tag(args, device=dev))
    wall_s = time.perf_counter() - t0
    n_train = SPSEDT_CLIPS["weak"] + SPSEDT_CLIPS["strong"]
    steps = n_train // args.batch_size
    assert not any(counts.values()), f"the audio-tag trainer must launch no K1-K4: {counts}"
    assert [e["epoch"] for e in res.epochs] == list(range(args.epochs))
    assert all(np.isfinite(e["loss"]) and e["steps"] == steps for e in res.epochs), res.epochs
    assert sorted(p.name for p in Path(res.model_dir).iterdir()) == ["at_avg_dcase"]
    d = res.data_timings
    assert d["extracted"] == d["clips"] == n_train + SPSEDT_CLIPS["validate"], d
    ck = load_checkpoint(res.checkpoint)
    AudioTagBackbone(args.backbone, args.dilation, args.pooling).load_state_dict(ck["model"])
    print(f"audio-tag trainer ({args.info}): {wall_s:.3f} s in all; feature extraction "
          f"{d['extracted']} clips in {d['features_s']:.3f} s, "
          f"{d['features_s'] / d['extracted'] * 1e3:.3f} ms a clip; scaler pass "
          f"{d['scaler_s']:.3f} s; K1-K4 no launch; best checkpoint of epoch {ck['epoch']} "
          f"loads back ({card})")
    for e in res.epochs:
        print(f"audio-tag trainer epoch {e['epoch']}: loss {e['loss']:.4f}, "
              f"{e['train_s'] / e['steps'] * 1e3:.3f} ms/step over {e['steps']} steps, "
              f"{args.batch_size * e['steps'] / e['train_s']:.1f} clips/s, data wait "
              f"{e['data_wait_s'] / e['steps'] * 1e3:.3f} ms/step; validation "
              f"{e['val_s'] * 1e3:.3f} ms, clip macro F1 {e['f1']:.4f}; checkpoint I/O "
              f"{e.get('checkpoint_s', 0.0):.3f} s ({card})")
    return {"name": Path(res.checkpoint).name, "counts": counts}


def checked_audio_tag_load(record: dict):
    """``train_lib.load_audio_tag_backbone`` checking, right after the load,
    the surgery's rules: every backbone parameter equals the audio-tag
    checkpoint's bit for bit, every other entry of the model (every FrozenBN
    buffer among them) is as it was, and nothing of the head (``fc1``,
    ``fc2``) lands."""
    real = train_lib.load_audio_tag_backbone

    def load(model, state):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = real(model, state)
        after = model.state_dict()
        backbone = {n for n, _ in model.named_parameters() if n.startswith("backbone.")}
        assert set(loaded) == backbone, sorted(backbone ^ set(loaded))
        for n, v in after.items():
            if n in backbone:
                assert torch.equal(v.cpu(), state[n]), n
            else:
                assert torch.equal(v, before[n]), n
        assert not any(k.startswith(("fc1.", "fc2.")) for k in after)
        record.update(loaded=loaded, buffers=sum(1 for _ in model.buffers()),
                      dropped=sorted(k for k in state if k not in after))
        return loaded

    return load


# --------------------------------------------------------------- SP-SEDT


def spsedt_batch(cfg: SEDTConfig, batch: int, seed: int) -> Batch:
    """``batch`` unlabeled synthetic clips at the config's geometry, each
    with ``num_patches`` random patch boxes as its targets (drawn from a
    seeded stream), on the CPU."""
    m = cfg.model
    enc = BoxEncoder(1, cfg.features.max_len_seconds, generate_patch=True)
    ds = SyntheticDataset(batch, cfg.data.classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                          max_events=2, seed=seed, unlabel=True, num_patches=m.num_patches,
                          rng=np.random.RandomState(seed))
    return collate([ds[i] for i in range(batch)], m.max_events, cfg.features.max_len_seconds)


def tiny_spsedt_config() -> SEDTConfig:
    """The tiny f32 config as SP-SEDT: resnet18, d 64, 1+1 layers, 6 queries
    from 3 patches, feature reconstruction, every patch query kept and
    dropout 0 (so no random draw decides anything), lr_backbone 0."""
    cfg = tiny_train_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, self_sup=True, dec_at=False, dec_layers=1,
                                  num_patches=3, feature_recon=True, mask_ratio=0.0),
        train=dataclasses.replace(cfg.train, lr_backbone=0.0))


def patch_crop_against_cpu(dev: torch.device, seed: int) -> float:
    """``extract_patches_device`` on the card against the CPU on the recipe's
    geometry (496 x 64 clips, 10 boxes each) and on a 100 x 48 one (which
    resizes along F too), to 1e-5; returns the largest difference."""
    rng = np.random.RandomState(seed)
    worst = 0.0
    for t, f in ((496, 64), (100, 48)):
        feats = torch.from_numpy(rng.randn(8, t, f, 1).astype(np.float32))
        boxes = torch.from_numpy(np.stack([get_random_patch_boxes(t, 10, rng=rng)
                                           for _ in range(8)]))
        ref = extract_patches_device(feats, boxes)
        got = extract_patches_device(feats.to(dev), boxes.to(dev)).cpu()
        assert got.shape == ref.shape == (8, 10, 128, 64, 1), got.shape
        assert torch.allclose(got, ref, rtol=0, atol=1e-5), float((got - ref).abs().max())
        worst = max(worst, float((got - ref).abs().max()))
    return worst


def small_spsedt_step(dev: torch.device, seed: int, steps: int = 2) -> float:
    """Two tiny f32 SP-SEDT train steps (``tiny_spsedt_config``, the crops
    cut on each device) on the card against the CPU; see
    ``train_steps_against_cpu``."""
    cfg = tiny_spsedt_config()
    return train_steps_against_cpu(cfg, spsedt_batch(cfg, 4, seed), dev, seed, steps)


def leaves_by_rule(model) -> dict:
    """Copies of the model's frozen leaves, lr-0 backbone leaves, main
    leaves and FrozenBN buffers, to check a step against."""
    out = {"frozen": {}, "backbone": {}, "main": {}}
    for n, p in model.named_parameters():
        out[param_label(n)][n] = p.detach().clone()
    out["buffers"] = {n: b.clone() for n, b in model.named_buffers()}
    return out


def check_spsedt_leaves(model, before: dict) -> int:
    """After SP-SEDT steps: the frozen leaves, the lr-0 backbone leaves and
    the FrozenBN buffers bit for bit as they were, most main leaves moved
    (those without a gradient only decay); returns how many moved."""
    now = dict(model.named_parameters())
    for group in ("frozen", "backbone"):
        assert before[group], f"no {group} leaves"
        for n, v in before[group].items():
            assert torch.equal(now[n].detach(), v), f"{group} parameter {n} changed"
            assert now[n].requires_grad == (group == "backbone"), n
    for n, b in model.named_buffers():
        assert torch.equal(b, before["buffers"][n]), f"FrozenBN buffer {n} changed"
    moved = sum(not torch.equal(now[n].detach(), v) for n, v in before["main"].items())
    assert moved > 0.9 * len(before["main"]), (moved, len(before["main"]))
    return moved


def patch_crop_bound(feats: torch.Tensor, boxes: torch.Tensor, out: torch.Tensor) -> dict:
    """The crop's least time: the features and boxes read once and the crops
    written once over the memory rate (its few operations an element are far
    below the f32 rate)."""
    nbytes = sum(t.numel() * t.element_size() for t in (feats, boxes, out))
    return {"ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def run_spsedt_step_phase(dev: torch.device, card: str, latency: dict, clock_hz: float) -> dict:
    """Phase 4e: the recipe's bare SP-SEDT step at batch 200
    (``SPSEDT_RECIPE``: ResNet-50 DC5, 6+3 layers, 20 queries from 10
    patches, feature reconstruction, 496 x 64, dropout 0.1, bf16 autocast,
    lr_backbone 0) through ``make_train_step``, the batch on the card: K1
    once a step at [600, 20, 20] and K2-K4 never; the frozen leaves, the
    lr-0 backbone leaves and the FrozenBN buffers bit for bit.  Returns K1's
    launches, parity error and timing on the step's own cost."""
    args = spsedt_args(SPSEDT_RECIPE)
    cfg = train_lib.spsedt_config(args)
    m = cfg.model
    bs = cfg.data.batch_size
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = init_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, wd, cfg, state.optimizer, augment_on=False, device=dev)
    cpu = spsedt_batch(cfg, bs, SEED)
    batch = Batch(feats=cpu.feats.to(dev), pad_mask=cpu.pad_mask.to(dev),
                  targets=type(cpu.targets)(*(t.to(dev) for t in cpu.targets)),
                  strong=cpu.strong.to(dev), weak=cpu.weak.to(dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SP-SEDT step: {describe(cfg, bs, n_params)}, {m.num_patches} patches of 128 x 64 a "
          f"clip, feature_recon {m.feature_recon}, mask ratio {m.mask_ratio}, dropout "
          f"{m.dropout}, lr_backbone {cfg.train.lr_backbone}")
    before = leaves_by_rule(model)

    _, costs = with_lsap_costs(lambda: step(batch, gen))  # warm-up 1, its cost kept
    (cost,) = costs
    assert cost.shape == (m.dec_layers * bs, m.num_queries, m.max_events), cost.shape
    k1_err = k1_against_references(cost.cpu().numpy(), dev, "the SP-SEDT step's own cost")
    for _ in range(SPSEDT_WARMUP - 1):
        step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_launch_counts()  # the main path: counts from here ...
    losses = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(SPSEDT_STEPS):
        losses.append(step(batch, gen)["loss"].clone())
    stop.record()
    stop.synchronize()
    host_s = (time.perf_counter() - t0) / SPSEDT_STEPS
    counts = launch_counts()  # ... to here
    event_ms = start.elapsed_time(stop) / SPSEDT_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all(), losses
    assert counts["K1"] == SPSEDT_STEPS and counts["K2"] == counts["K3"] == counts["K4"] == 0, (
        f"the SP-SEDT step must launch K1 once a step and K2-K4 never: {counts}")
    moved = check_spsedt_leaves(model, before)
    print(f"SP-SEDT step: {event_ms:.3f} ms/step by CUDA events, {bs / event_ms * 1e3:.1f} "
          f"clips/s ({bs * m.num_patches / event_ms * 1e3:.1f} patches/s); {host_s * 1e3:.3f} "
          f"ms/step by the host clock; {SPSEDT_STEPS} steps, K1 {counts['K1']} launches at "
          f"{list(cost.shape)}, K2-K4 none; losses {losses[0]:.4f} .. {losses[-1]:.4f}; "
          f"{moved} of {len(before['main'])} main leaves moved, {len(before['backbone'])} lr-0 "
          f"backbone leaves, {len(before['frozen'])} frozen ones and {len(before['buffers'])} "
          f"FrozenBN buffers unchanged bit for bit; peak memory {peak / 2**30:.3f} GiB ({card})")
    flops = step_flops(model, wd, cfg, batch, gen)
    print(f"SP-SEDT step: {flops / 1e9:.1f} GFLOP a step counted by FlopCounterMode, "
          f"{flops / bs / 1e9:.2f} GFLOP a clip with its patches; at {event_ms:.3f} ms that is "
          f"{flops / (event_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{flops / (event_ms * 1e-3) / BF16_OPS_PER_S:.4f} of the dense bf16 peak ({card})")
    profile(lambda: step(batch, gen), "SP-SEDT step", card, "spsedt_step_profile.txt")
    boxes = batch.targets.boxes[:, :m.num_patches]
    crop = extract_patches_device(batch.feats, boxes)
    crop_ms = device_ms(lambda: extract_patches_device(batch.feats, boxes))
    bound = patch_crop_bound(batch.feats, boxes, crop)
    print(f"SP-SEDT patch crop {list(crop.shape)}: {crop_ms:.5f} ms on the device, bound "
          f"{bound['ms']:.5f} ms by bytes ({bound['bytes']} B) ({card})")
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 3, latency,
                     clock_hz)
    return {"launches": counts["K1"], "err": k1_err, "shape": list(cost.shape), "timing": timing}


def checked_pretrain_load(record: dict):
    """``train_lib.load_pretrain_into`` checking, right after the load, the
    surgery's rules: every parameter loaded equals the checkpoint's (the
    query table's rows 1:), the class heads and query row 0 keep their
    values, parameters the checkpoint lacks (or has at another shape) too,
    and the FrozenBN buffers are untouched."""
    real = train_lib.load_pretrain_into

    def load(model, state):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loaded = real(model, state)
        after = model.state_dict()
        buffers = {n for n, _ in model.named_buffers()}
        for n, v in after.items():
            old = state.get(n)
            if n == "query_embed.weight":
                assert torch.equal(v[1:].cpu(), old) and torch.equal(v[0], before[n][0]), n
            elif n in buffers or "class_embed" in n or old is None or old.shape != v.shape:
                assert n not in loaded and torch.equal(v, before[n]), n
            else:
                assert n in loaded and torch.equal(v.cpu(), old), n
        record.update(loaded=loaded, kept=len(after) - len(loaded),
                      dropped=sorted(k for k in state if k not in after))
        return loaded

    return load


# ------------------------------------------- the graphed step against eager


@contextlib.contextmanager
def first_dropout_spy():
    """Each armed step's first dropout, ``[x, dropout(x)]``, copied into one
    buffer on the device.  The copy is a kernel, so a captured step refills
    the buffer on every replay.  Set ``spy.armed`` before each step;
    ``spy.buf`` holds the pair after it."""
    real = transformer.dropout
    spy = types.SimpleNamespace(armed=False, buf=None)

    def dropout(x, rate, generator, deterministic, shard=None):
        out = real(x, rate, generator, deterministic, shard)
        if spy.armed and not deterministic and rate > 0:
            spy.armed = False
            if spy.buf is None:
                spy.buf = torch.empty((2, *x.shape), dtype=x.dtype, device=x.device)
            spy.buf[0].copy_(x.detach())
            spy.buf[1].copy_(out.detach())
        return out

    transformer.dropout = dropout
    try:
        yield spy
    finally:
        transformer.dropout = real


def graph_cell_config(cell: str) -> SEDTConfig:
    """The widths of a SEDT cell of the benchmark at ``GRAPH_BATCH``: the
    URBAN-SED supervised recipe, or SP-SEDT's pretrain recipe."""
    if cell == "sedt-urbansed":
        return flagship_config(GRAPH_BATCH)
    cfg = train_lib.spsedt_config(spsedt_args(SPSEDT_RECIPE))
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=GRAPH_BATCH))


def graph_batches(cfg: SEDTConfig, dev: torch.device, seed: int) -> list:
    """``GRAPH_STEPS`` seeded batches on the card."""
    if cfg.model.self_sup:
        host = [spsedt_batch(cfg, GRAPH_BATCH, seed + k) for k in range(GRAPH_STEPS)]
    else:
        host = make_batches(cfg, GRAPH_BATCH, GRAPH_STEPS, seed)[1]
    return [Batch(b.feats.to(dev), b.pad_mask.to(dev), DenseTargets(*(t.to(dev) for t in b.targets)),
                  b.strong.to(dev), b.weak.to(dev)) for b in host]


def graph_run(cfg: SEDTConfig, batches: list, dev: torch.device, seed: int, graphed: bool,
              drop: bool = True) -> dict:
    """The train steps of ``cfg`` on ``batches``, from weights and a
    generator seeded ``seed``, the lr cut tenfold from update
    ``GRAPH_LR_DROP_AT`` on (with ``drop``): with the real optimizer
    (graphed from the second step on) or behind
    ``try_remat_torch.EagerOptimizer``.  Returns each step's loss and first
    dropout, every trained leaf, its start and AdamW's moments after the
    last step, the step's graph counts, K1's launches and the groups' final
    lr tensors."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, adjust_lr=True,
                                                lr_drop=1 if drop else 10 ** 6))
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    state = init_train_state(model, cfg, steps_per_epoch=GRAPH_LR_DROP_AT)
    opt = state.optimizer
    step = make_train_step(model, wd, cfg,
                           opt if graphed else try_remat_torch.EagerOptimizer(opt),
                           augment_on=not cfg.model.self_sup, device=dev)
    names = {id(p): n for n, p in model.named_parameters()}
    start = {names[id(p)]: p.detach().clone() for p in opt.params}
    gen = torch.Generator(device=dev).manual_seed(seed)
    k1 = hungarian.lsap_lane.launches
    losses, drops = [], []
    with first_dropout_spy() as spy:
        for b in batches:
            spy.armed = True
            losses.append(step(b, gen)["loss"].clone())
            drops.append(spy.buf.clone())
    torch.cuda.synchronize()
    out = {"losses": torch.stack(losses).cpu(), "drops": [d.cpu() for d in drops],
           "leaves": {names[id(p)]: p.detach().cpu() for p in opt.params},
           "start": {k: v.cpu() for k, v in start.items()},
           "moments": {names[id(p)]: (opt.adamw.state[p]["exp_avg"].cpu(),
                                      opt.adamw.state[p]["exp_avg_sq"].cpu()) for p in opt.params},
           "counts": step.graph.counts(), "k1": hungarian.lsap_lane.launches - k1,
           "lr": [float(t) for t in opt.lr]}
    del step, state, opt, model
    torch.cuda.empty_cache()
    return out


def run_gap(a: dict, b: dict) -> float:
    """How far run ``b`` lies from run ``a``: the largest of each step's loss
    difference over the loss, the leaves' largest difference over the
    largest change any leaf made, and each moment's largest difference over
    its largest entry."""
    gaps = [float(((b["losses"] - a["losses"]) / a["losses"]).abs().max())]
    moved = max(float((a["leaves"][n] - a["start"][n]).abs().max()) for n in a["leaves"])
    gaps.append(max(float((b["leaves"][n] - v).abs().max()) for n, v in a["leaves"].items())
                / moved)
    for n, moments in a["moments"].items():
        for m_a, m_b in zip(moments, b["moments"][n]):
            scale = float(m_a.abs().max())
            if scale > 0:
                gaps.append(float((m_b - m_a).abs().max()) / scale)
    return max(gaps)


def keep_masks(run: dict) -> list:
    """Each step's dropout keep mask, and where it is known (x != 0)."""
    return [(d[1] != 0, d[0] != 0) for d in run["drops"]]


def graphed_step_against_eager(dev: torch.device, cell: str, seed: int) -> dict:
    """``GRAPH_STEPS`` steps of the graphed train step against the eager one
    at a SEDT cell's widths, from the same weights, generator seed and
    batches, the lr cut from update ``GRAPH_LR_DROP_AT`` on.  The graphed
    run must read 1 eager call, 1 capture and ``GRAPH_STEPS - 1`` replays,
    launch K1 once a step and end at the cut lr; its dropout keep masks
    must be the eager run's (where both inputs are non-zero) and differ
    from one replay to the next; its losses, trained leaves and AdamW
    moments must lie within ``GRAPH_GAP_FACTOR`` times the gap between two
    eager runs of the eager run, and an eager run without the cut must lie
    farther than 10 times that, and farther than 0.
    Returns the gaps and the counts."""
    cfg = graph_cell_config(cell)
    batches = graph_batches(cfg, dev, seed)
    eager = graph_run(cfg, batches, dev, seed, graphed=False)
    again = graph_run(cfg, batches, dev, seed, graphed=False)
    graphed = graph_run(cfg, batches, dev, seed, graphed=True)
    uncut = graph_run(cfg, batches, dev, seed, graphed=False, drop=False)
    n = GRAPH_STEPS
    assert eager["counts"] == (0, 0, n) and graphed["counts"] == (1, n - 1, 1), (
        eager["counts"], graphed["counts"])
    assert eager["k1"] == graphed["k1"] == n, (eager["k1"], graphed["k1"])
    assert graphed["lr"] == eager["lr"] != uncut["lr"], (graphed["lr"], eager["lr"])
    masks, ref = keep_masks(graphed), keep_masks(eager)
    for k, ((keep, known), (keep_e, known_e)) in enumerate(zip(masks, ref)):
        both = known & known_e
        assert both.float().mean() > 0.2 and torch.equal(keep[both], keep_e[both]), (
            f"step {k}: the graphed step's dropout mask is not the eager step's")
    both = masks[2][1] & masks[3][1]
    assert not torch.equal(masks[2][0][both], masks[3][0][both]), "two replays drew one mask"
    gaps = {"eager": run_gap(eager, again), "graph": run_gap(eager, graphed),
            "uncut": run_gap(eager, uncut)}
    tol = GRAPH_GAP_FACTOR * gaps["eager"]
    assert gaps["graph"] <= tol, f"{cell}: graphed against eager {gaps}, tolerance {tol:.3g}"
    assert gaps["uncut"] > max(10 * tol, 0.0), f"{cell}: the lr cut hides under the tolerance: {gaps}"
    return {"gaps": gaps, "tol": tol, "counts": graphed["counts"], "k1": graphed["k1"],
            "losses": graphed["losses"].tolist()}


def evaluation_between_replays(dev: torch.device, seed: int) -> dict:
    """The graphed supervised step at the URBAN-SED cell's widths (batch
    ``GRAPH_BATCH``) with an evaluation's forward after its third call and
    again after three replays more.  A replay writes the trained weights
    without moving their version counters, and the evaluation caches the
    trained convolutions' folded weights by them: each forward must be the
    forward of a deep copy of the model as it is then (a copy's folds start
    empty), within ``EVAL_FOLD_SHARE`` of how far the second forward lies
    from the first; the graph must last through both evaluations (1 eager
    call, 1 capture, 5 replays).  Returns each evaluation's gap to its copy
    over the gap between the two evaluations, and the counts."""
    cfg = graph_cell_config("sedt-urbansed")
    batches = graph_batches(cfg, dev, seed)
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    state = init_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, wd, cfg, state.optimizer, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = batches[0]

    def forward() -> list:
        """The model's forward and its fresh copy's, flattened."""
        twin = copy.deepcopy(model)
        with torch.inference_mode():
            outs = [m(b.feats, b.pad_mask) for m in (model, twin)]
        return [torch.cat([o[k].float().flatten() for k in ("pred_logits", "pred_boxes")])
                for o in outs]

    evals = []
    for k in range(6):
        step(batches[k], gen)
        if k in (2, 5):
            evals.append(forward())
    counts = step.graph.counts()
    moved = float((evals[1][0] - evals[0][0]).abs().max())
    gaps = [float((own - fresh).abs().max()) / moved for own, fresh in evals]
    assert counts == (1, 5, 1), counts
    assert moved > 0 and max(gaps) <= EVAL_FOLD_SHARE, (
        f"an evaluation between replays lies {gaps} of the step's move {moved:.3g} from a "
        f"fresh copy's: stale folded weights")
    del step, state, model
    torch.cuda.empty_cache()
    return {"gaps": gaps, "moved": moved, "counts": counts}


def run_graph_phase(dev: torch.device, card: str) -> dict:
    """Phase 4e': the graphed train step against the eager one at both SEDT
    cells' widths (``graphed_step_against_eager``), and evaluations between
    its replays (``evaluation_between_replays``)."""
    r = evaluation_between_replays(dev, SEED)
    print(f"evaluations between replays of the graphed sedt-urbansed step: each the forward of "
          f"a fresh copy to {r['gaps']} of the move between them ({r['moved']:.3g}); "
          f"{r['counts']} ({card})")
    out = {"evaluation": r}
    for cell in ("sedt-urbansed", "spsedt-dcase"):
        out[cell] = r = graphed_step_against_eager(dev, cell, SEED)
        g = r["gaps"]
        print(f"graphed {cell} step, batch {GRAPH_BATCH}, {GRAPH_STEPS} steps against eager: "
              f"gap {g['graph']:.3g} (two eager runs {g['eager']:.3g}, tolerance "
              f"{r['tol']:.3g}; without the lr cut {g['uncut']:.3g}); {r['counts']}; K1 "
              f"{r['k1']} launches; dropout masks the eager run's ({card})")
    return out


def run_spsedt_chain_phase(dev: torch.device, card: str) -> dict:
    """Phase 4f: audio tags -> pretrain -> fine-tune -> semi at full width on
    disk.  It writes a seeded DCASE layout (``SPSEDT_CLIPS``), runs
    ``run_audio_tag`` on its weak and synthetic clips (``AT_CHAIN``; K1-K4
    none), then ``run_spsedt --pretrain at_avg_dcase`` on its unlabeled clips
    (``SPSEDT_CHAIN``: the recipe at batch 200, 2 epochs of 2 steps, the
    ``.npy`` cache and the scaler built on the run, a checkpoint every epoch;
    K1 4 launches, K2-K4 none), whose backbone surgery is checked leaf for
    leaf, then ``run_supervised --dec_at --pretrain <its checkpoint>`` for 1
    epoch at batch 32 (16 strong and 16 weak clips a step; strategies 1-3),
    whose surgery is checked leaf for leaf, then the semi stage.  Returns the
    audio-tag stage's launch counts and the other stages' K1 launches."""
    shutil.rmtree(SPSEDT_ROOT, ignore_errors=True)
    shutil.rmtree(SPSEDT_EXP, ignore_errors=True)
    t0 = time.perf_counter()
    wav_dataset.write_dcase(SPSEDT_ROOT, seed=SEED, **SPSEDT_CLIPS)
    write_s = time.perf_counter() - t0
    n = sum(SPSEDT_CLIPS.values())
    print(f"SP-SEDT chain dataset: {n} DCASE clips of 10 s at 16 kHz ({SPSEDT_CLIPS}) written "
          f"in {write_s:.3f} s, {write_s / n * 1e3:.3f} ms a clip ({card})")
    at = run_audio_tag_chain(dev, card)
    args = spsedt_args(SPSEDT_CHAIN + ["--pretrain", at["name"]])
    at_surgery: dict = {}
    real_load = train_lib.load_audio_tag_backbone
    train_lib.load_audio_tag_backbone = checked_audio_tag_load(at_surgery)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        pre, k1, _, counts, _ = counted_launches(lambda: train_lib.run_spsedt(args, device=dev))
        wall_s = time.perf_counter() - t0
    finally:
        train_lib.load_audio_tag_backbone = real_load
    assert at_surgery, "the pretrainer did not load the audio-tag checkpoint"
    peak = torch.cuda.max_memory_allocated(dev)
    steps = SPSEDT_CLIPS["unlabel"] // args.batch_size
    assert k1 == args.epochs * steps and counts["K2"] == counts["K3"] == counts["K4"] == 0, (
        f"the pretrainer must launch K1 once a step and K2-K4 never: {counts}")
    assert [e["epoch"] for e in pre.epochs] == list(range(args.epochs))
    assert all(np.isfinite(e["loss"]) and e["steps"] == steps for e in pre.epochs), pre.epochs
    assert pre.bank, "the pretrainer did not hold its features in a bank"
    names = sorted(p.name for p in Path(pre.model_dir).iterdir())
    assert names == sorted([at["name"], args.info]
                           + [f"{args.info}_{e}" for e in range(args.epochs)]), names
    d = pre.data_timings
    assert d["extracted"] == d["clips"] == SPSEDT_CLIPS["unlabel"], d
    print(f"SP-SEDT pretrainer --pretrain {at['name']}: {len(at_surgery['loaded'])} backbone "
          f"parameters loaded bit for bit, {at_surgery['buffers']} FrozenBN buffers kept (not "
          f"the checkpoint's statistics), {len(at_surgery['dropped'])} checkpoint entries "
          f"without a home (the head) ({card})")
    print(f"SP-SEDT pretrainer ({args.info}): {wall_s:.3f} s in all; feature extraction "
          f"{d['extracted']} clips in {d['features_s']:.3f} s, "
          f"{d['features_s'] / d['extracted'] * 1e3:.3f} ms a clip; scaler pass "
          f"{d['scaler_s']:.3f} s; K1 {k1} launches, K2-K4 none; peak memory "
          f"{peak / 2**30:.3f} GiB ({card})")
    ckpt_s = d["final_checkpoint_s"]
    for e in pre.epochs:
        ckpt_s += e.get("checkpoint_s", 0.0)
        print(f"SP-SEDT pretrainer epoch {e['epoch']}: loss {e['loss']:.4f}, "
              f"{e['train_s'] / e['steps'] * 1e3:.3f} ms/step, "
              f"{args.batch_size * e['steps'] / e['train_s']:.1f} clips/s, data wait "
              f"{e['data_wait_s'] / e['steps'] * 1e3:.3f} ms/step; checkpoint I/O "
              f"{e.get('checkpoint_s', 0.0):.3f} s ({card})")
    print(f"SP-SEDT pretrainer: checkpoint I/O {ckpt_s:.3f} s in all, the final one "
          f"{d['final_checkpoint_s']:.3f} s ({card})")

    ft_args = sedt_args(FINE_TUNE_CHAIN + ["--pretrain", args.info])
    want = trainer_launches(ft_args, SPSEDT_CLIPS["strong"] + SPSEDT_CLIPS["weak"],
                            SPSEDT_CLIPS["validate"], SPSEDT_CLIPS["test"])
    surgery: dict = {}
    real_load = train_lib.load_pretrain_into
    train_lib.load_pretrain_into = checked_pretrain_load(surgery)
    try:
        t0 = time.perf_counter()
        ft, k1_train, k1_eval, counts, _ = counted_launches(
            lambda: train_lib.run_supervised(ft_args, device=dev))
        wall_s = time.perf_counter() - t0
    finally:
        train_lib.load_pretrain_into = real_load
    assert surgery, "the fine-tune did not load the pretrain checkpoint"
    assert (k1_train, k1_eval) == (want["train"], want["eval"]), (
        f"K1 launched {k1_train} times in train steps and {k1_eval} in eval steps, "
        f"not {want['train']} and {want['eval']}")
    assert counts["K2"] == counts["K3"] == counts["K4"] == 0, counts
    assert all(np.isfinite(e["loss"]) for e in ft.epochs), ft.epochs
    assert [r["fusion_strategy"] for r in ft.final] == list(ft_args.fusion_strategy)
    dropped = [k for k in surgery["dropped"] if k.startswith("transformer.encoder_layer_")]
    assert {k.split(".")[1] for k in dropped} == {
        f"encoder_layer_{i}" for i in range(ft_args.enc_layers, args.enc_layers)}, dropped
    e = ft.epochs[0]
    print(f"SP-SEDT fine-tune ({ft_args.info}): {len(surgery['loaded'])} parameters loaded from "
          f"{args.info}, {surgery['kept']} entries kept (class heads, query row 0, FrozenBN "
          f"buffers), {len(surgery['dropped'])} checkpoint entries without a home (the patch "
          f"heads, encoder layers {ft_args.enc_layers}-{args.enc_layers - 1}); {wall_s:.3f} s in all; loss {e['loss']:.4f}, "
          f"{e['train_s'] / e['steps'] * 1e3:.3f} ms/step, data wait "
          f"{e['data_wait_s'] / e['steps'] * 1e3:.3f} ms/step; K1 {k1_train} launches in train "
          f"steps, {k1_eval} in eval steps, K2-K4 none; F1 {ft.f1} ({card})")
    semi = run_semi_chain(dev, card, f"{ft_args.info}_{ft_args.fusion_strategy[0]}_best")
    return {"audio_tag": at["counts"], "pretrain": k1, "fine_tune": k1_train + k1_eval,
            "semi": semi}


# ------------------------------------------------------------- semi trainer


def semi_batch(cfg: SEDTConfig, sizes, seed: int) -> Batch:
    """``sizes`` = (strong, weak, unlabeled) seeded synthetic clips at the
    config's geometry, labeled rows first, on the CPU."""
    m = cfg.model
    sec = cfg.features.max_len_seconds
    enc = BoxEncoder(list(cfg.data.classes), sec)
    kinds = ({}, {"weak_only": True}, {"unlabel": True})
    items = []
    for k, (n, kw) in enumerate(zip(sizes, kinds)):
        ds = SyntheticDataset(n, cfg.data.classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                              max_events=3, seconds=sec, seed=seed + k, **kw)
        items += [ds[i] for i in range(n)]
    return collate(items, m.max_events, sec)


def semi_flags(sizes, dev: torch.device) -> tuple:
    """The semi batch's (strong, weak, unlabel) flags by position."""
    pos = torch.arange(sum(sizes), device=dev)
    return pos < sizes[0], (pos >= sizes[0]) & (pos < sizes[0] + sizes[1]), pos >= sizes[0] + sizes[1]


def fixed_views(feats, cfg, generator):
    """The clean view and, in place of a noisy one drawn from the device's
    own stream, the clean one times 1.0625: card and CPU then see the same
    student input."""
    return feats, feats * 1.0625


def small_semi_step(dev: torch.device, seed: int, steps: int = 2) -> float:
    """Two tiny f32 semi steps (2 strong, 2 weak, 4 unlabeled clips; dropout
    0, no mixup; the fixed student view; a teacher 1 % apart from the
    student, so that the pseudo boxes are not the student's predictions;
    thresholds at 0.05, under every score of the random teacher) on the card
    against the CPU, TF32 off: the pseudo counts exactly and above 0 in
    every step, the losses, every parameter of the student and of the
    teacher to 1e-3.  Returns the largest difference."""
    cfg = tiny_train_config()
    sizes = (2, 2, 4)
    cpu = semi_batch(cfg, sizes, seed)
    runs = []  # the CPU's, then the card's
    with cudnn_tf32_off():
        for d in (torch.device("cpu"), dev):
            model, wd = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
            state = init_train_state(model, cfg, steps_per_epoch=10, schedule="cosine")
            teacher = make_teacher(model)
            g = torch.Generator().manual_seed(seed + 1)
            with torch.no_grad():
                for p in teacher.parameters():
                    p.add_((0.01 * p.abs().mean().cpu() * torch.randn(p.shape, generator=g)).to(d))
            step = make_semi_train_step(wd, cfg, n_labeled=sizes[0] + sizes[1], device=d)
            gen = torch.Generator(device=d).manual_seed(seed)
            thr = torch.full((cfg.model.num_classes,), 0.05, device=d)
            runs.append([])
            for _ in range(steps):
                tf, sf = fixed_views(cpu.feats.to(d), cfg, gen)
                metrics, counts = step(state, teacher, tf, sf, cpu.pad_mask, cpu.targets,
                                       *semi_flags(sizes, d), thr, gen, True)
                runs[-1].append((
                    {k: v.cpu() for k, v in metrics.items()}, counts.cpu(),
                    {f"student {k}": v.cpu().clone() for k, v in model.state_dict().items()}
                    | {f"teacher {k}": v.cpu().clone() for k, v in teacher.state_dict().items()}))
    worst = 0.0
    for (ref_m, ref_c, ref_p), (got_m, got_c, got_p) in zip(*runs, strict=True):
        assert torch.equal(got_c, ref_c) and ref_c.sum() > 0, (got_c, ref_c)
        for k, r in ref_m.items():
            assert torch.isfinite(got_m[k]).item() and torch.allclose(got_m[k], r, rtol=1e-3,
                                                                      atol=1e-3), (k, got_m[k], r)
            worst = max(worst, float((got_m[k] - r).abs()))
        for k, r in ref_p.items():
            assert torch.allclose(got_p[k], r, rtol=1e-3, atol=1e-3), k
            worst = max(worst, float((got_p[k] - r).abs().max()))
    print(f"tiny semi step, card vs CPU: pseudo counts {[c.tolist() for _, c, _ in runs[1]]}")
    return worst


def write_semi_teacher(cfg: SEDTConfig, path: Path, seed: int, raised: int = 2) -> None:
    """Seeded weights with class ``raised`` favoured (its logit bias up by 6,
    its audio-tag bias by 4), so that the teacher labels the unlabeled
    clips, as the checkpoint ``{"model": ...}`` that ``--teacher_model``
    reads."""
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.class_embed.bias[raised] += 6.0
        model.weak_class_embed.bias[raised] += 4.0
    save_checkpoint(str(path), {"model": model.state_dict()})


def small_semi_trainer(dev: torch.device) -> float:
    """``run_semi`` at the tiny size (``TINY_SEMI``: resnet18, d 64, 1+2
    layers, semi batch 8, 16 clips a stream, 2 epochs, dropout 0, no
    mixup or masks, lr 1e-5, the fixed student view, a teacher checkpoint
    favouring one class) on the card and on the CPU, TF32 off: each epoch's
    loss means, pseudo counts, adapted thresholds and validation F1 to 1e-3,
    the counts above 0.  Returns the largest difference."""
    runs = []  # the CPU's, then the card's
    real_views = train_lib.semi_views
    train_lib.semi_views = fixed_views
    try:
        with cudnn_tf32_off():
            for i, d in enumerate((torch.device("cpu"), dev)):
                root = Path(TRAIN_ROOT + "_tiny_semi") / f"{i}_{d.type}"
                shutil.rmtree(root, ignore_errors=True)
                args = semi_args(TINY_SEMI + ["--exp_root", str(root)])
                write_semi_teacher(train_lib.args_to_config(args),
                                   root / "dcase" / "model" / "teacher", SEED)
                runs.append(train_lib.run_semi(args, device=d))
    finally:
        train_lib.semi_views = real_views
    ref, got = runs
    pairs = []
    for r, g in zip(ref.epochs, got.epochs, strict=True):
        assert sum(r["pseudo_counts"]) > 0, r["pseudo_counts"]
        for key in ("loss_means", "val_loss_means", "val_f1"):
            pairs += [(f"epoch {r['epoch']} {key} {k}", g[key][k], v) for k, v in r[key].items()]
        for key in ("pseudo_counts", "thresholds"):
            pairs += [(f"epoch {r['epoch']} {key} {c}", g[key][c], v)
                      for c, v in enumerate(r[key])]
    worst = 0.0
    for name, g, r in pairs:
        assert np.isfinite(g) and np.isclose(g, r, rtol=1e-3, atol=1e-3), (name, g, r)
        worst = max(worst, abs(float(g) - float(r)))
    print(f"tiny semi trainer, card vs CPU: {len(pairs)} values; pseudo counts "
          f"{[e['pseudo_counts'] for e in got.epochs]}, thresholds "
          f"{[e['thresholds'] for e in got.epochs]}")
    return worst


def split_semi_step(model, teacher, wd, cfg, optimizer, batch, flags, thr, gen, n_lab: int,
                    card: str) -> None:
    """The semi step's device time by part
    (``profile_semi_torch.semi_step_parts`` on the step's own views, without
    the mixups)."""
    views = train_lib.semi_views(batch.feats, cfg, gen)
    parts = profile_semi_torch.semi_step_parts(model, teacher, wd, cfg, optimizer, views, batch,
                                               flags, thr, gen, n_lab, busy_ms)
    total = sum(parts.values())
    for name, ms in parts.items():
        print(f"semi step part {name}: {ms:.4f} ms of device time, {ms / total:.4f} of the "
              f"parts' {total:.3f} ms ({card})")


def mixed_rows_carry_labels(teacher, cfg, batch, thr, gen, n_lab: int, sizes) -> tuple:
    """The step's mixup of labeled clips into the head of the unlabeled
    stream, on the card: the teacher's pseudo targets of the step's clean
    views, mixed with the labeled targets; some mixed head rows must hold
    more events than their pseudo targets did.  Returns (rows that carry
    labeled events, rows mixed)."""
    tf, sf = train_lib.semi_views(batch.feats, cfg, gen)
    unl = slice(n_lab, None)
    with torch.no_grad():
        pseudo, _ = get_pseudo_labels(teacher(tf[unl], batch.pad_mask[unl]), thr,
                                      batch.targets.orig_size[unl], cfg.model.max_events)
    labeled = DenseTargets(*(t[:n_lab] for t in batch.targets))
    _, mixed = augment.mixup_label_unlabel(tf[:n_lab], sf[unl], labeled, pseudo, gen,
                                           mix_up_ratio=cfg.augment.mix_up_ratio, alpha=1.0,
                                           max_events=cfg.model.max_events)
    n_mix = int(min(sizes[2], n_lab) * cfg.augment.mix_up_ratio)
    carried = int((mixed.box_valid[:n_mix].sum(1) > pseudo.box_valid[:n_mix].sum(1)).sum())
    assert carried > 0, "no mixed head row carries a labeled event"
    assert torch.equal(mixed.box_valid[n_mix:], pseudo.box_valid[n_mix:])
    return carried, n_mix


def check_ema(teacher, before: list, model, decay: float) -> float:
    """The teacher after a step with the EMA against d * e + (1 - d) * p over
    every parameter (the frozen ones too), to 1e-6 of the terms' size;
    returns the largest relative difference."""
    worst = 0.0
    for t, e, p in zip(teacher.parameters(), before, model.parameters(), strict=True):
        e, p = e.double(), p.detach().double()
        want = decay * e + (1 - decay) * p
        scale = decay * e.abs() + (1 - decay) * p.abs()
        rel = float(((t.double() - want).abs() / scale.clamp_min(1e-30)).max())
        assert rel <= 1e-6, rel
        worst = max(worst, rel)
    return worst


def run_semi_step_phase(dev: torch.device, card: str, latency: dict, clock_hz: float) -> dict:
    """Phase 4g: the README's semi step (``SEMI_RECIPE``: ResNet-50 DC5, 3+3
    layers, d 256, 20 queries, ``dec_at``, focal loss, mixup 0.6, frequency
    mask and shift; dropout 0.1, bf16 autocast; 496 x 64, batch 64 = 16
    strong + 16 weak + 32 unlabeled) through ``train_lib.semi_views`` and
    ``make_semi_train_step``, the batch on the card: K1 once a step at
    [192, 20, 20] and K2-K4 never; the EMA against its formula, the teacher
    untouched without it, the student's frozen leaves and the FrozenBN
    buffers bit for bit.  Returns K1's launches, parity error and timing on
    the step's own cost."""
    args = semi_args(SEMI_RECIPE)
    cfg = train_lib.args_to_config(args)
    m = cfg.model
    bs = args.semi_batch_size
    sizes = (bs // 4, bs // 4, bs // 2)
    n_lab = sizes[0] + sizes[1]
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    state = init_train_state(model, cfg, steps_per_epoch=100, schedule="cosine")
    teacher = make_teacher(model)
    step = make_semi_train_step(wd, cfg, fine_tune=cfg.train.fine_tune,
                                normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                                n_labeled=n_lab, device=dev)
    cpu = semi_batch(cfg, sizes, SEED)
    batch = Batch(feats=cpu.feats.to(dev), pad_mask=cpu.pad_mask.to(dev),
                  targets=DenseTargets(*(t.to(dev) for t in cpu.targets)),
                  strong=cpu.strong.to(dev), weak=cpu.weak.to(dev))
    flags = semi_flags(sizes, dev)
    thr = torch.full((m.num_classes,), SEMI_THRESHOLD, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def run(do_ema: bool = True):
        tf, sf = train_lib.semi_views(batch.feats, cfg, gen)
        return step(state, teacher, tf, sf, batch.pad_mask, batch.targets, *flags, thr, gen,
                    do_ema)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"semi step: {describe(cfg, bs, n_params)} ({sizes[0]} strong, {sizes[1]} weak, "
          f"{sizes[2]} unlabeled), a teacher of {n_params} more, dropout {m.dropout}, mixup "
          f"{cfg.augment.mix_up_ratio}, freq mask {cfg.augment.freq_mask}, freq shift "
          f"{cfg.augment.freq_shift}, focal loss {cfg.train.focal_loss}, thresholds "
          f"{SEMI_THRESHOLD}, EMA decay {cfg.train.ema_decay}")
    before = leaves_by_rule(model)

    (_, counts), costs = with_lsap_costs(run)  # warm-up 1, its cost kept
    (cost,) = costs
    assert cost.shape == (m.dec_layers * bs, m.num_queries, m.max_events), cost.shape
    k1_err = k1_against_references(cost.cpu().numpy(), dev, "the semi step's own cost")
    ema_before = [p.detach().clone() for p in teacher.parameters()]
    run(True)
    ema_err = check_ema(teacher, ema_before, model, cfg.train.ema_decay)
    kept = {k: v.clone() for k, v in teacher.state_dict().items()}
    run(False)
    assert all(torch.equal(v, kept[k]) for k, v in teacher.state_dict().items()), (
        "the teacher moved in a step without the EMA")
    carried, n_mix = mixed_rows_carry_labels(teacher, cfg, batch, thr, gen, n_lab, sizes)
    for _ in range(SEMI_WARMUP - 3):  # the three steps above warm up too
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_launch_counts()  # the main path: counts from here ...
    losses, pseudo = [], []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(SEMI_STEPS):
        metrics, counts = run()
        losses.append(metrics["loss"])
        pseudo.append(counts)
    stop.record()
    stop.synchronize()
    host_s = (time.perf_counter() - t0) / SEMI_STEPS
    launched = launch_counts()  # ... to here
    event_ms = start.elapsed_time(stop) / SEMI_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    pseudo = torch.stack(pseudo).cpu()
    assert torch.isfinite(losses).all(), losses
    assert launched["K1"] == SEMI_STEPS and launched["K2"] == launched["K3"] == launched["K4"] == 0, (
        f"the semi step must launch K1 once a step and K2-K4 never: {launched}")
    now = dict(model.named_parameters())
    for n, v in before["frozen"].items():
        assert torch.equal(now[n].detach(), v), f"frozen parameter {n} changed"
    for n, b in model.named_buffers():
        assert torch.equal(b, before["buffers"][n]), f"FrozenBN buffer {n} changed"
    moved = sum(not torch.equal(now[n].detach(), v) for n, v in before["main"].items())
    print(f"semi step: {event_ms:.3f} ms/step by CUDA events, {bs / event_ms * 1e3:.1f} clips/s; "
          f"{host_s * 1e3:.3f} ms/step by the host clock; {SEMI_STEPS} steps, K1 "
          f"{launched['K1']} launches at {list(cost.shape)}, K2-K4 none; losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; pseudo events a step {pseudo.sum(1).tolist()}, "
          f"by class over the {SEMI_STEPS} steps {pseudo.sum(0).tolist()}; EMA within "
          f"{ema_err:.3g} of d*e + (1-d)*p, teacher unchanged without it; {carried} of the "
          f"{n_mix} mixed head rows' pseudo targets carry labeled events; {moved} of "
          f"{len(before['main'])} main leaves moved, {len(before['frozen'])} frozen ones and "
          f"{len(before['buffers'])} FrozenBN buffers unchanged; peak memory "
          f"{peak / 2**30:.3f} GiB ({card})")
    with FlopCounterMode(display=False) as counter:
        run()
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    print(f"semi step: {flops / 1e9:.1f} GFLOP a step counted by FlopCounterMode (both "
          f"forwards, the backward), {flops / bs / 1e9:.2f} GFLOP a clip; at {event_ms:.3f} ms "
          f"that is {flops / (event_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{flops / (event_ms * 1e-3) / BF16_OPS_PER_S:.4f} of the dense bf16 peak ({card})")
    profile(run, "semi step", card, "semi_step_profile.txt")
    split_semi_step(model, teacher, wd, cfg, state.optimizer, batch, flags, thr, gen, n_lab, card)
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 3, latency,
                     clock_hz)
    return {"launches": launched["K1"], "err": k1_err, "shape": list(cost.shape),
            "timing": timing}


def semi_launches(args, sizes: dict) -> dict:
    """K1's launches that the semi trainer's arguments call for on a DCASE
    layout of ``sizes`` clips: one per plain train step, one per eval batch
    (every epoch's validation, then validation and eval for each strategy's
    final test)."""
    bs = args.semi_batch_size
    steps = min(sizes["strong"] // (bs // 4), sizes["weak"] // (bs // 4),
                sizes["unlabel"] // (bs // 2))
    batches = lambda n: -(-n // args.batch_size)
    return {"train": args.epochs * steps,
            "eval": args.epochs * batches(sizes["validate"])
            + len(args.fusion_strategy) * (batches(sizes["validate"]) + batches(sizes["test"]))}


def run_semi_chain(dev: torch.device, card: str, teacher_model: str) -> int:
    """The chain's semi stage (phase 4f, after the fine-tune): ``run_semi``
    at ``SEMI_RECIPE``'s width on the phase's DCASE layout (64 strong, 64
    weak, 400 unlabeled clips: 4 steps an epoch, 2 epochs, a checkpoint
    every epoch) from the fine-tune's best checkpoint, whose features are
    cached already; K1 exactly as the arguments call for, K2-K4 none; the
    final test on the best teacher; the best and periodic checkpoints load
    back.  Returns K1's launches."""
    args = semi_args(SEMI_CHAIN + ["--teacher_model", teacher_model])
    want = semi_launches(args, SPSEDT_CLIPS)
    t0 = time.perf_counter()
    res, k1_train, k1_eval, counts, _ = counted_launches(lambda: train_lib.run_semi(args,
                                                                                   device=dev))
    wall_s = time.perf_counter() - t0
    assert (k1_train, k1_eval) == (want["train"], want["eval"]), (
        f"K1 launched {k1_train} times in train steps and {k1_eval} in eval steps, not "
        f"{want['train']} and {want['eval']}")
    assert counts["K2"] == counts["K3"] == counts["K4"] == 0, counts
    assert [e["epoch"] for e in res.epochs] == list(range(args.epochs))
    assert all(np.isfinite(e["loss"]) for e in res.epochs), res.epochs
    assert res.bank and [r["model"] for r in res.final] == ["teacher"] * len(res.final)
    model, _ = build_model(train_lib.args_to_config(args), device=dev)
    for name in [f"{args.info}_{m}_best" for m in args.fusion_strategy] + [
            f"{args.info}_{e}" for e in range(args.epochs)]:
        ck = load_checkpoint(str(Path(res.model_dir) / name))
        model.load_state_dict(ck["model"])
        model.load_state_dict(ck["teacher"])
    ckpt_s = 0.0
    for e in res.epochs:
        ckpt_s += e.get("checkpoint_s", 0.0)
        print(f"semi trainer epoch {e['epoch']}: loss {e['loss']:.4f} (sup "
              f"{sum(v for k, v in e['loss_means'].items() if k.startswith('sup_loss')):.4f}, "
              f"unsup {sum(v for k, v in e['loss_means'].items() if k.startswith('unsup_loss')):.4f}"
              f" unweighted), {e['train_s'] / e['steps'] * 1e3:.3f} ms/step over {e['steps']} "
              f"steps, {args.semi_batch_size * e['steps'] / e['train_s']:.1f} clips/s, data wait "
              f"{e['data_wait_s'] / e['steps'] * 1e3:.3f} ms/step; pseudo counts "
              f"{[int(c) for c in e['pseudo_counts']]}, thresholds next "
              f"{[round(t, 4) for t in e['thresholds']]}; validation F1 {e['val_f1']}; "
              f"checkpoint I/O {e.get('checkpoint_s', 0.0):.3f} s ({card})")
    print(f"semi trainer ({args.info}, teacher {teacher_model}): {wall_s:.3f} s in all; K1 "
          f"{k1_train} launches in train steps, {k1_eval} in eval steps, K2-K4 none; final "
          f"test on the best teacher, eval F1 {res.f1}; checkpoint I/O {ckpt_s:.3f} s; every "
          f"checkpoint loads back ({card})")
    return k1_train + k1_eval


# ------------------------------------------------------- several processes

MP_ROOT = "build/chip_multiprocess"
MP_STEPS = 3  # flagship steps of phase 4i, (a) and (b)
MP_BANK = (256, 64, 3)  # phase 4i's sharded bank: clips at 500 x 64, global batch, gathers
# (b): the CPU tests' tolerances for the first step's loss (1e-5 relative)
# and Adam's update on the pinned entries (1e-3 of the lr); under bf16 the
# batch split moves roundings of the gradients, so fewer entries are pinned
# (at least half) and the later steps, from parameters that the unpinned
# entries moved apart, are held to 1e-2.  The first step's gradients hold
# every entry: leaf by leaf to 0.1 of the leaf's largest
# (``dryrun.grad_error``; world 2 against 1 measured 0.025 on an H100 80GB
# HBM3 at 700 W, a gradient off by 2x gives 0.5)
MP_BF16_TOL = dict(loss_rtol=1e-5, later_rtol=1e-2, update_tol=1e-3, min_pinned=0.5,
                   grad_tol=0.1)


# (a): DDP at one rank against no group, the same arithmetic: losses to 1e-6
# relative, the first step's gradients to 1e-6 of their leaf's largest,
# Adam's update on the pinned entries to 1e-3 of the lr (bit for bit where
# the backward's kernels are deterministic)
MP_WORLD1_TOL = dict(loss_rtol=1e-6, later_rtol=1e-6, update_tol=1e-3, grad_tol=1e-6)


def bit_for_bit(ref: dict, got: dict) -> bool:
    """Whether two leg results hold the same losses, the same first-step
    gradients and every parameter and buffer equal bit for bit."""
    return (ref["loss"] == got["loss"]
            and ref["grads"].keys() == got["grads"].keys()
            and all(torch.equal(v, got["grads"][k]) for k, v in ref["grads"].items())
            and all(torch.equal(v, got["params"][k]) for k, v in ref["params"].items()))


def run_multiprocess_phase(dev: torch.device, card: str, clock_hz: float, latency: dict,
                           k1_err: float) -> dict:
    """Phase 4i: the train step under ``torch.distributed``.  (a) the
    flagship step (bench_torch's configuration and batch of 64, dropout 0,
    bf16 autocast) under DDP in a group of one over NCCL against the same
    steps without a group; (b) the same global batch over two ranks on this
    one card (gloo: NCCL refuses two ranks on one device) against (a)'s
    steps without a group, K1 once a step on each rank at [96, 10, 20], the
    ranks' parameters bit for bit after every step, with a sharded feature
    bank at 500 x 64 gathered on both ranks; (c) the dryrun's five legs at
    the tiny config over the same two ranks against one process
    (``parallel/dryrun.py``, its CPU tolerances).  (b) and (c) run in one
    spawn; a rank's failure raises here."""
    root = Path(MP_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = flagship_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))
    m = cfg.model
    state = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))[0]
    flagship = dict(leg="step", device=str(dev), cfg=cfg, state=state.state_dict(),
                    batch=synthetic_batch(cfg, cfg.data.batch_size, "cpu"),
                    streams=[cfg.data.batch_size], steps=MP_STEPS, seed=SEED,
                    steps_per_epoch=100, time_allreduce=True)
    del state
    tiny = dryrun.tiny_inputs(str(dev), batch=8, steps=2)
    clips, gbatch, gathers = MP_BANK
    gather_rng = np.random.RandomState(SEED)
    bank = dict(leg="bank", device=str(dev), cfg=cfg, clips=clips, clip_seed=SEED, train=False,
                indexes=[gather_rng.permutation(clips)[:gbatch].tolist() for _ in range(gathers)])

    # (a) world 1: without a group, DDP in a group of one over NCCL, without
    # a group again (the two runs without a group bracket DDP's timing)
    one = dryrun.leg_step(flagship)
    init_distributed(backend="nccl", device=dev, init_method=f"file://{root.resolve()}/nccl_store",
                     rank=0, world_size=1)
    ddp1 = dryrun.leg_step(flagship)
    dist.destroy_process_group()
    again = dryrun.leg_step(flagship)
    res1 = dryrun.compare(one, [ddp1], flagship["state"], cfg.train.lr, cfg.train.weight_decay,
                          **MP_WORLD1_TOL)
    exact = bit_for_bit(one, ddp1)
    assert exact or res1["ok"], f"DDP at world 1 against the step without a group: {res1}"
    assert one["k1"] == ddp1["k1"] == again["k1"] == MP_STEPS, (one["k1"], ddp1["k1"])
    ms = {k: float(np.mean(r["step_s"][1:])) * 1e3 for k, r in (("first", one), ("ddp", ddp1),
                                                                  ("again", again))}
    plain_ms = (ms["first"] + ms["again"]) / 2
    print(f"(a) flagship train step, DDP over NCCL at world 1 on {dev} against no group: "
          f"{'bit for bit' if exact else 'ok'} (gradients {res1['grad_err']:.3g} of their "
          f"leaf's largest, losses {res1['loss_rel']:.3g} and "
          f"{res1['later_rel']:.3g} relative, Adam's update within {res1['update_err']:.3g} of "
          f"the lr on {res1['pinned']:.1%} of the entries); without a group {ms['first']:.3f} then {ms['again']:.3f} ms/step, under "
          f"DDP between them {ms['ddp']:.3f} ms/step ({ms['ddp'] / plain_ms - 1:+.2%} against "
          f"their mean), steps 2-{MP_STEPS} of each run by the host clock after a synchronize "
          f"({card})")

    # (b) and (c): two ranks on this card, gloo, one spawn
    refs = {name: dryrun.LEGS[inp["leg"]](inp) for name, inp in tiny.items()}
    inputs = dict(tiny, flagship=flagship, flagship_bank=bank)
    path = root / "inputs.pt"
    torch.save(inputs, path)
    del inputs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.run_legs, 2, (str(path), str(root / "out"), ["flagship_bank", "flagship",
                                                                      *tiny]),
                 str(root), device=str(dev), backend="gloo")
    spawn_s = time.perf_counter() - t0

    got = dryrun.load_results(str(root / "out"), "flagship", 2)
    res = dryrun.compare(one, got, flagship["state"], cfg.train.lr, cfg.train.weight_decay,
                         **MP_BF16_TOL)
    shape = (m.dec_layers * cfg.data.batch_size // 2, m.num_queries, m.max_events)
    for r in got:
        assert r["k1"] == MP_STEPS and tuple(r["k1_shape"]) == shape, (
            f"K1 must launch once a step on each rank at {list(shape)}: {r['k1']} launches, "
            f"last at {r['k1_shape']}")
        assert all(np.isfinite(r["loss"]))
    assert res["ranks_equal"], "the ranks' parameters must be equal bit for bit after every step"
    assert res["ok"], f"(b) world 2 against world 1 beyond the bf16 tolerances {MP_BF16_TOL}: {res}"
    ms_two = float(np.mean(got[0]["step_s"][1:])) * 1e3
    ar_ms = got[0]["allreduce_ms"]
    n_grad = sum(g.numel() for g in got[0]["grads"].values())
    print(f"(b) flagship train step over 2 ranks on {dev} (gloo), global batch "
          f"{cfg.data.batch_size} ({cfg.data.batch_size // 2} a rank), {MP_STEPS} steps against "
          f"(a) without a group: step 1's gradients within {res['grad_err']:.3g} of their "
          f"leaf's largest (worst {res['grad_leaf']}), loss {res['loss_rel']:.3g} relative at "
          f"step 1, later steps "
          f"{res['later_rel']:.3g}; Adam's update after step 1 on the {res['pinned']:.1%} of "
          f"entries both gradients pin within {res['update_err']:.3g} of the lr; the ranks' "
          f"parameters bit for bit after every step; K1 {[r['k1'] for r in got]} launches at "
          f"{list(shape)} a rank; {ms_two:.3f} ms/step (steps 2-{MP_STEPS}, rank 0, host "
          f"clock), one all_reduce of the {n_grad} trainable gradients alone {ar_ms:.3f} ms "
          f"({ar_ms / ms_two:.1%} of a step); spawn to exit {spawn_s:.1f} s ({card})")

    gb = dryrun.load_results(str(root / "out"), "flagship_bank", 2)
    assert all(all(r["bank_equal"]) for r in gb) and gb[0]["sharded"]
    gather_ms = [float(np.mean(r["gather_s"][1:])) * 1e3 for r in gb]
    print(f"(b) sharded feature bank, {clips} clips at {m.max_frames} x {m.n_mels} over 2 ranks "
          f"on {dev} (gloo): {gathers} gathers of a global batch of {gbatch}, each rank's "
          f"{gbatch // 2} rows equal to the dataset's; {gather_ms[0]:.3f} ms a gather on rank 0, "
          f"{gather_ms[1]:.3f} ms on rank 1 (gathers 2-{gathers}, host clock) ({card})")

    report = {}
    for name, inp in tiny.items():
        lr, wd = dryrun.lr_and_decay(inp)
        two = dryrun.load_results(str(root / "out"), name, 2)
        report[name] = dryrun.compare(refs[name], two, inp["state"], lr, wd)
        if inp["leg"] == "bank":
            report[name]["ok"] &= all(all(r["bank_equal"]) for r in two) and two[0]["sharded"]
        assert report[name]["ok"], f"(c) dryrun leg {name} at world 2 on {dev}: {report[name]}"
    print(f"(c) dryrun legs at world 2 on {dev} (gloo) against one process: "
          + "; ".join(f"{name} ok (gradients {r['grad_err']:.2g}, loss {r['loss_rel']:.2g}, "
                      f"update {r['update_err']:.2g} lr, "
                      f"K1 {r['k1']})" for name, r in report.items()) + f" ({card})")
    cost = seeded_k1_cost(shape, "big", dev)
    timing = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5, latency,
                     clock_hz)
    return {"shape": list(shape), "launches": [r["k1"] for r in got], "timing": timing,
            "err": k1_err}


# ------------------------------------------------------- tensor parallel

TP_ROOT = "build/chip_tensor_parallel"
BATCH_TP = 64  # bench_torch's batch
TP_STEPS = 3  # flagship steps of phase 4j (a) in bf16 and (d)
TP_F32 = (32, 2)  # (a) in f32: batch, steps
# (a) in bf16 against one process at dropout 0.1, and (d) at 2 x 2 against
# 2 x 1: the masks are the same (drawn whole and sliced), but the cut GEMMs
# have other shapes and their partial products are rounded to bf16 before
# their sum, so bf16 roundings move: the first step's loss is held to 1e-3
# relative and its gradients to phase 4i (b)'s bf16 tolerance of 0.1 of the
# leaf's largest, the later steps to 1e-2.  Adam's first update is about
# lr * sign(g), so in bf16 the share of entries whose sign both gradients pin
# measures the roundings: held at 40 %, under the 48.0-48.5 % that (a)
# measured on an H100 80GB HBM3 at 700 W (48.0 % with the partials in bf16),
# and the pinned entries' update to the CPU tests' 1e-3 of the lr.  In f32
# (a) runs again at the CPU tests' tolerances (``dryrun.compare``'s
# defaults, TF32 off)
TP_BF16_TOL = dict(loss_rtol=1e-3, later_rtol=1e-2, grad_tol=0.1, update_tol=1e-3,
                   min_pinned=0.4)


def layouts_that_raise(dev: torch.device) -> list:
    """Phase 4j (c): the layouts the port refuses, each before any step:
    the flagship's 8 heads over 16 model ranks (its 256-wide projections
    divide, so JAX would cut inside a head), and grids that do not fill the
    world.  Returns the messages; K1 must not have launched."""
    reset_launch_counts()
    raised = []
    model, _ = build_model(flagship_config(), device=dev)
    for attempt in (lambda: shard_model(model, 16, 0),
                    lambda: layout_shape(MeshConfig(n_model=2), 3),
                    lambda: layout_shape(MeshConfig(n_data=3, n_model=2), 4),
                    lambda: dryrun.run_dryrun({}, 4, TP_ROOT, str(dev),
                                              mesh=MeshConfig(n_model=3))):
        try:
            attempt()
        except ValueError as e:
            raised.append(str(e))
        else:
            raise AssertionError("a layout the port cannot run did not raise")
    assert launch_counts()["K1"] == 0
    assert all(getattr(m, "model_parts", 1) == 1 for m in model.modules())
    return raised


def tp_flagship_input(dev: torch.device, batch: int, steps: int, **model_kw) -> dict:
    """The flagship step's leg input (dropout 0.1) at ``batch`` clips."""
    cfg = flagship_config(batch)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
    state = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))[0]
    return dict(leg="step", device=str(dev), cfg=cfg, state=state.state_dict(),
                batch=synthetic_batch(cfg, batch, "cpu"), streams=[batch], steps=steps,
                seed=SEED, steps_per_epoch=100, time_collectives=True)


def check_tp_ranks(got: list, steps: int, shape: tuple, layout: list) -> None:
    """Each rank of (a) or (d): the ``layout``, the projections cut where it
    has a model axis, K1 once a step at ``shape``, finite losses, the
    replicated parameters bit for bit on every rank and each cut one across
    its data ranks after every step."""
    for r in got:
        assert r["layout"] == layout and (r["n_cut"] > 0) == (layout[1] > 1), (
            r["layout"], r["n_cut"])
        assert r["k1"] == steps and tuple(r["k1_shape"]) == shape, (
            f"K1 must launch once a step on each rank at {list(shape)}: {r['k1']} launches, "
            f"last at {r['k1_shape']}")
        assert all(np.isfinite(r["loss"]))
        assert all(r["replicated_equal"]) and all(r["cut_equal"]), (
            "the replicated parameters must be equal bit for bit on every rank after every "
            f"step: {r['replicated_equal']}, the cut ones across data ranks: {r['cut_equal']}")


@contextlib.contextmanager
def ffn_signs(d_model: int, d_ff: int):
    """While open, keep, call by call, which of the FFNs' hidden
    pre-activations are positive (a global forward hook on every
    ``d_model`` -> ``d_ff`` Linear, the FFNs' first ones); yields the list."""
    signs = []

    def hook(module, args, out):
        if (isinstance(module, torch.nn.Linear) and module.in_features == d_model
                and module.out_features == d_ff):
            signs.append(out.detach() > 0)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield signs
    finally:
        handle.remove()


def f32_step_sensitivity(inp: dict, one: dict) -> dict:
    """Phase 4j (a) in f32: how far one process's step moves the first
    step's gradients when nothing, or one rounding, changes.  The leg again
    (``repeat_equal``: bit for bit with ``one``, the run (a) compares with;
    ``repeat_err``: :func:`dryrun.grad_error` of the two), and again with
    every clip's features moved by one ulp (``ulp``: its
    :func:`dryrun.compare` against the repeat); ``flips`` counts the first
    forward's FFN hidden pre-activations whose sign the ulp changes, of
    ``units``: a ReLU whose input lies within rounding of 0 passes or stops
    that unit's whole gradient on that row.  Where the ulp moves an FFN's
    first bias most, ``unit`` is the hidden unit it moves most and
    ``unit_rows`` the rows on which that unit's pre-activation changed
    sign."""
    m = inp["cfg"].model
    n = m.enc_layers + m.dec_layers  # FFN calls of the first forward, encoder first
    feats = inp["batch"].feats
    moved = dict(inp, batch=inp["batch"]._replace(
        feats=torch.nextafter(feats, torch.full_like(feats, math.inf))))
    with ffn_signs(m.hidden_dim, m.dim_feedforward) as a:
        again = dryrun.leg_step(inp)
    with ffn_signs(m.hidden_dim, m.dim_feedforward) as b:
        ulp = dryrun.leg_step(moved)
    out = {"repeat_equal": bit_for_bit(one, again),
           "repeat_err": dryrun.grad_error(one["grads"], again["grads"])[0],
           "flips": sum(int((x != y).sum()) for x, y in zip(a[:n], b[:n])),
           "units": sum(x.numel() for x in a[:n]),
           "ulp": dryrun.compare(again, [ulp], inp["state"], inp["cfg"].train.lr,
                                 inp["cfg"].train.weight_decay)}
    leaf = out["ulp"]["grad_leaf"]
    if leaf.endswith(".ffn.linear1.bias"):  # transformer.<kind>_layer_<i>.ffn...
        kind, i = leaf.split(".")[1].rsplit("_", 1)
        call = int(i) + (m.enc_layers if kind == "decoder_layer" else 0)
        out["unit"] = int((again["grads"][leaf] - ulp["grads"][leaf]).abs().argmax())
        out["unit_rows"] = int((a[call] != b[call])[..., out["unit"]].sum())
    return out


def tp_line(tag: str, inp: dict, got: list, r: dict, against: str, shape,
            card: str) -> str:
    """The printed line of one (a) or (d) comparison."""
    m = inp["cfg"].model
    d, n = got[0]["layout"]
    return (f"{tag} flagship train step in {m.compute_dtype} at {d} x {n} (data x model) on "
            f"{inp['device']} (gloo), batch {len(inp['batch'].feats)}, "
            f"{len(inp['batch'].feats) // d} a data rank, {m.nheads // n} of {m.nheads} heads "
            f"and {m.dim_feedforward // n} of {m.dim_feedforward} hidden units a rank, dropout "
            f"{m.dropout}, {inp['steps']} steps against {against}: step 1's gradients within "
            f"{r['grad_err']:.3g} of their leaf's largest (worst {r['grad_leaf']}), loss "
            f"{r['loss_rel']:.3g} relative at step 1, later steps {r['later_rel']:.3g}; Adam's "
            f"update after step 1 on the {r['pinned']:.1%} of entries both gradients pin within "
            f"{r['update_err']:.3g} of the lr; the replicated parameters bit for bit on every "
            f"rank after every step; K1 {[x['k1'] for x in got]} launches at {list(shape)} a "
            f"rank ({card})")


def tp_times(got: list, one_s: list) -> tuple:
    """(ms/step of each rank, ms in the tensor-parallel all_reduces of each,
    ms/step of the reference), steps 2 on, host clock and CUDA events."""
    return ([float(np.mean(x["step_s"][1:])) * 1e3 for x in got],
            [float(np.mean(x["collective_ms"][1:])) for x in got],
            float(np.mean(one_s[1:])) * 1e3)


def run_tensor_parallel_phase(dev: torch.device, card: str, clock_hz: float, latency: dict,
                              k1_err: float) -> dict:
    """Phase 4j: the flagship train step under tensor parallel.  (a) (1 x 2)
    ranks on this card over gloo against the same steps in one process, in
    bf16 and in f32, and what one rounding does to f32's one-process step;
    (d) (2 x 2) ranks in bf16 against (2 x 1), which draws the same dropout
    masks; (b) the dryrun's five tiny legs at (2 x 2); (c) layouts that
    raise.  A rank's failure raises here."""
    root = Path(TP_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    raised = layouts_that_raise(dev)
    print(f"(c) layouts the port cannot run raise before any step, K1 never launched: "
          + "; ".join(raised))

    bf16 = tp_flagship_input(dev, BATCH_TP, TP_STEPS)
    f32 = tp_flagship_input(dev, *TP_F32, compute_dtype="float32")
    # (d)'s reference: the same global batch over two data ranks, which draw
    # their own masks (seeded by data rank), in (a)'s group
    inputs = {"flagship_tp": bf16, "flagship_tp_f32": f32,
              "flagship_dp": dict(bf16, mesh=MeshConfig(n_model=1), time_collectives=False)}
    ones = {name: dryrun.leg_step(inputs[name]) for name in ("flagship_tp", "flagship_tp_f32")}
    cause = f32_step_sensitivity(f32, ones["flagship_tp_f32"])
    path = root / "inputs.pt"
    torch.save(inputs, path)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.run_legs, 2, (str(path), str(root / "out"), list(inputs),
                                      MeshConfig(n_model=2)),
                 str(root), device=str(dev), backend="gloo")
    spawn_s = time.perf_counter() - t0
    shapes = {}
    for name in ("flagship_tp", "flagship_tp_f32"):
        inp = inputs[name]
        cfg, m = inp["cfg"], inp["cfg"].model
        got = dryrun.load_results(str(root / "out"), name, 2)
        shapes[name] = (m.dec_layers * len(inp["batch"].feats), m.num_queries, m.max_events)
        check_tp_ranks(got, inp["steps"], shapes[name], [1, 2])
        tol = TP_BF16_TOL if name == "flagship_tp" else {}
        r = dryrun.compare(ones[name], got, inp["state"], cfg.train.lr, cfg.train.weight_decay,
                           **tol)
        print(tp_line("(a)", inp, got, r, "one process", shapes[name], card))
        assert r["ok"], f"(a) {name} at 1 x 2 against world 1 beyond {tol or 'the CPU tolerances'}: {r}"
    u = cause["ulp"]
    unit = (f"; its largest move is on hidden unit {cause['unit']}, whose pre-activation "
            f"changed sign on {cause['unit_rows']} rows" if "unit" in cause else "")
    print(f"(a) f32 in one process, what one rounding does: the same steps again bit for bit: "
          f"{cause['repeat_equal']} (gradients {cause['repeat_err']:.3g} of their leaf's "
          f"largest); with every clip's features one ulp up, step 1's gradients move "
          f"{u['grad_err']:.3g} of their leaf's largest (worst {u['grad_leaf']}), the loss "
          f"{u['loss_rel']:.3g} relative, and {cause['flips']} of {cause['units']} FFN hidden "
          f"pre-activations of the first forward change sign{unit} ({card})")
    got_tp = dryrun.load_results(str(root / "out"), "flagship_tp", 2)
    ms_tp, coll_ms, ms_one = tp_times(got_tp, ones["flagship_tp"]["step_s"])
    print(f"(a) bf16 flagship step at 1 x 2: {ms_tp[0]:.3f} / {ms_tp[1]:.3f} ms/step on ranks "
          f"0 / 1 (steps 2-{TP_STEPS}, host clock) against {ms_one:.3f} in one process; the "
          f"tensor-parallel all_reduces {coll_ms[0]:.3f} / {coll_ms[1]:.3f} ms a step "
          f"({coll_ms[0] / ms_tp[0]:.1%} / {coll_ms[1] / ms_tp[1]:.1%}; CUDA events around "
          f"each); spawn to exit {spawn_s:.1f} s for the three runs ({card})")

    m = bf16["cfg"].model
    shape = (m.dec_layers * BATCH_TP // 2, m.num_queries, m.max_events)
    dp = dryrun.load_results(str(root / "out"), "flagship_dp", 2)
    check_tp_ranks(dp, TP_STEPS, shape, [2, 1])
    path = root / "inputs_2x2.pt"
    torch.save({"flagship_2x2": bf16}, path)
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.run_legs, 4, (str(path), str(root / "out"), ["flagship_2x2"],
                                      MeshConfig(n_model=2)),
                 str(root), device=str(dev), backend="gloo")
    spawn_s = time.perf_counter() - t0
    got4 = dryrun.load_results(str(root / "out"), "flagship_2x2", 4)
    check_tp_ranks(got4, TP_STEPS, shape, [2, 2])
    r = dryrun.compare(dp[0], got4, bf16["state"], bf16["cfg"].train.lr,
                       bf16["cfg"].train.weight_decay, **TP_BF16_TOL)
    print(tp_line("(d)", bf16, got4, r, "2 x 1 (DDP over the same two data "
                  "ranks, the same masks)", shape, card))
    assert r["ok"], f"(d) the flagship step at 2 x 2 against 2 x 1 beyond {TP_BF16_TOL}: {r}"
    ms_4, coll_4, ms_dp = tp_times(got4, dp[0]["step_s"])
    print(f"(d) bf16 flagship step at 2 x 2: {' / '.join(f'{x:.3f}' for x in ms_4)} ms/step on "
          f"ranks 0-3 (steps 2-{TP_STEPS}, host clock) against {ms_dp:.3f} at 2 x 1; the "
          f"tensor-parallel all_reduces {' / '.join(f'{x:.3f}' for x in coll_4)} ms a step "
          f"({' / '.join(f'{c / t:.1%}' for c, t in zip(coll_4, ms_4))}; CUDA events around "
          f"each); spawn to exit {spawn_s:.1f} s ({card})")

    report = dryrun.run_dryrun(dryrun.tiny_inputs(str(dev), batch=8, steps=2), 4,
                               str(root / "dryrun"), device=str(dev), backend="gloo",
                               mesh=MeshConfig(n_model=2))
    for name, r in report.items():
        assert r["ok"] and r["layout"] == [2, 2], f"(b) dryrun leg {name} at 2 x 2 on {dev}: {r}"
    print(f"(b) dryrun legs at 2 x 2 (data x model) on {dev} (gloo) against one process: "
          + "; ".join(f"{name} ok (gradients {r['grad_err']:.2g}, loss {r['loss_rel']:.2g}, "
                      f"update {r['update_err']:.2g} lr, K1 {r['k1']})"
                      for name, r in report.items()) + f" ({card})")
    timing = {}
    for label, sh in (("1x2", shapes["flagship_tp"]), ("2x2", shape)):
        cost = seeded_k1_cost(sh, "big", dev)
        timing[label] = time_jv("K1", hungarian.lsap_lane, hungarian.lsap_plain, cost, card, 5,
                                latency, clock_hz)
    return {"shape": list(shapes["flagship_tp"]), "launches": [x["k1"] for x in got_tp],
            "timing": timing["1x2"], "shape_2x2": list(shape),
            "launches_2x2": [x["k1"] for x in got4], "timing_2x2": timing["2x2"], "err": k1_err}


# ----------------------------------------------------------------- tools

# phase 4k: each measuring tool's functions at its JAX counterpart's geometry,
# with few iterations (the tools' defaults take 5-20)
TOOLS_ITERS = 3  # timed calls of each row or step
TOOLS_TRACE_STEPS = 3  # traced flagship steps; 2 of the semi and SP-SEDT steps
TOOLS_BANK_REPEATS = 1  # timed passes of each SP-SEDT loop
TOOLS_BUSY_TOL = 0.15  # a trace's device total against busy_ms of the same step


def tools_counts(total: dict) -> dict:
    """The counts since the last reset, added into ``total``."""
    counts = launch_counts()
    for k in ("K1", "K2", "K3", "K4", "K4 backward"):
        total[k] = total.get(k, 0) + counts[k]
    return counts


def check_tool_launches(label: str, counts: dict, steps: int) -> None:
    assert counts["K1"] == steps and counts["K2"] == counts["K3"] == counts["K4"] == 0, (
        f"{label}: K1 must launch once a step ({steps}) and K2-K4 never: {counts}")


def check_tool_reading(label: str, r) -> None:
    assert math.isfinite(r.ms) and r.ms > 0 and r.device_ms is not None, (label, r)
    assert math.isfinite(r.device_ms) and r.device_ms > 0, (label, r)


def traced_steps(run, out: str, steps: int, card: str, label: str, busy: float) -> dict:
    """``capture_trace_torch.capture`` of ``steps`` steps (one warm-up) and
    ``trace_report_torch``'s table of it: ``jv_warp_kernel`` (K1) once a
    traced step, counted under ``hand-written`` and by name, and the
    trace's device total a step within ``TOOLS_BUSY_TOL`` of ``busy``
    (``busy_ms`` of the same step)."""
    shutil.rmtree(out, ignore_errors=True)
    path = capture_trace_torch.capture(run, out, steps, warmup=1)
    table = trace_table(path, top=12)
    raw = trace_table(path, raw=True, top=100000)
    kinds = collections.Counter()
    jv = 0
    for plane in table["planes"].values():
        kinds.update({k: n for k, _, _, n in plane["rows"]})
    for plane in raw["planes"].values():
        jv += sum(n for k, _, _, n in plane["rows"] if "jv_warp_kernel" in k)
    assert kinds["hand-written"] == jv == steps, (label, kinds, jv)
    total = sum(p["total_ms"] for p in table["planes"].values()) / steps
    print(f"{label} trace ({Path(path).name}): {steps} steps, device {total:.3f} ms a step "
          f"in the trace, jv_warp_kernel {jv} times under hand-written ({card})")
    for line in trace_report_torch.report_lines(table):
        print("  " + line)
    for plane, p in raw["planes"].items():
        print(f"  {plane}, the 10 largest kernels by name:")
        for name, ms, share, count in p["rows"][:10]:
            print(f"    {ms / steps:9.4f} ms a step {100 * share:5.1f}% x{count // steps:<5d} "
                  f"{name[:120]}")
    assert abs(total - busy) <= TOOLS_BUSY_TOL * busy, (label, total, busy)
    print(f"{label} trace: {total:.3f} ms a step against busy_ms {busy:.3f} ms, "
          f"{total / busy - 1:+.4f} ({card})")
    return {"device_ms_per_step": total, "path": path}


def run_tools_phase(dev: torch.device, card: str) -> dict:
    """Phase 4k: the measuring tools (``tools/*_torch.py``) on the card at
    their JAX counterparts' geometries: ``profile_step_torch``'s rows of the
    flagship step (bf16, batch 64; and its ``--step_only`` at the tool's
    default f32), ``capture_trace_torch`` + ``trace_report_torch`` of the
    flagship, semi and SP-SEDT steps, ``profile_semi_torch`` (6+6 layers,
    batch 64, ``--components``), ``profile_spsedt_torch`` (6+6, batch 200),
    ``bench_spsedt_bank_torch`` (batch 200, 8 steps a loop) and
    ``try_remat_torch`` (its f32 check first, then the four variants timed
    in bf16).
    Every row finite and positive, K1 once a step (a row's call) and K2-K4
    never, the traces' K1 once a traced step and each trace's device total
    within 15 % of ``busy_ms``, the bank loops' losses equal, every remat
    variant the baseline's step.  Returns the phase's launch counts."""
    total = {}
    n = TOOLS_ITERS
    t0 = time.perf_counter()
    lap = lambda label: print(f"phase 4k {label}: {time.perf_counter() - t0:.1f} s from the "
                              f"phase's start")
    f32 = profile_step_torch.train_setup(profile_step_torch.step_config(64), dev)
    reset_launch_counts()  # each tool's path: counts from here ...
    checked = try_remat_torch.check_variants(f32)
    check_tool_launches("try_remat_torch check", tools_counts(total),  # ... to here
                        len(try_remat_torch.VARIANTS))
    for v, d in checked.items():
        print(f"try_remat_torch {v}: first f32 step as baseline's: loss {d['loss']:.3g} of it, "
              f"gradients {d['grad']:.3g} of their leaf's largest ({d['leaf']}), the same "
              f"generator state")
    reset_launch_counts()
    r = profile_step_torch.step_rows(f32, n, step_only=True)["train_step"]
    check_tool_launches("profile_step_torch --step_only", tools_counts(total), r.calls)
    check_tool_reading("train_step f32", r)
    print("profile_step_torch --step_only (the tool's default f32; TF32 convolutions "
          f"{torch.backends.cudnn.allow_tf32}, matmuls {torch.backends.cuda.matmul.allow_tf32})")
    print(profile_step_torch.format_row("train_step", r, 64, card))
    del f32
    torch.cuda.empty_cache()
    lap("try_remat_torch's check and profile_step_torch --step_only")

    cfg = profile_step_torch.step_config(64, "bfloat16")
    s = profile_step_torch.train_setup(cfg, dev)
    n_params = sum(p.numel() for p in s.model.parameters())
    print(f"tools: profile_step_torch, {describe(cfg, 64, n_params)}")
    reset_launch_counts()
    rows = profile_step_torch.step_rows(s, n)
    check_tool_launches("profile_step_torch", tools_counts(total),
                        sum(rows[k].calls for k in profile_step_torch.K1_ROWS) + 1)
    print(f"profile_step_torch batch=64 dtype=bfloat16 dropout={cfg.model.dropout} iters={n} "
          f"({card})")
    for name, r in rows.items():
        if r.calls:
            check_tool_reading(name, r)
        assert math.isfinite(r.ms) and r.ms > 0 and r.device_ms > 0, (name, r)
        print(profile_step_torch.format_row(name, r, 64, card))
    flagship = traced_steps(s.run, "build/tools_trace/flagship", TOOLS_TRACE_STEPS, card,
                            "flagship step", rows["train_step"].device_ms)
    reset_launch_counts()
    timed = try_remat_torch.time_variants(s, n)
    check_tool_launches("try_remat_torch", tools_counts(total),
                        sum(r.calls for r, _ in timed.values()))
    for v, (r, peak) in timed.items():
        check_tool_reading(v, r)
        print(f"try_remat_torch {v:9s}: {r.ms:.3f} ms/step ({64 / r.ms * 1e3:.0f} clips/s), "
              f"device {r.device_ms:.3f} ms, peak memory {peak / 2**30:.3f} GiB ({card})")
    del s
    torch.cuda.empty_cache()
    lap("profile_step_torch, the flagship trace and try_remat_torch's timing")

    scfg = profile_semi_torch.semi_config()
    ss = profile_semi_torch.semi_setup(scfg, dev)
    reset_launch_counts()
    r = measure(ss.run, n, dev)
    check_tool_launches("profile_semi_torch", tools_counts(total), r.calls)
    check_tool_reading("semi step", r)
    print(f"profile_semi_torch batch=64 enc/dec=6/6 dtype=bfloat16: {r.ms:.3f} ms "
          f"({64 / r.ms * 1e3:.0f} clips/s); device {r.device_ms:.3f} ms ({card})")
    for name, ms in profile_semi_torch.components(ss, r).items():
        assert math.isfinite(ms) and ms > 0, (name, ms)
        print(f"  {name}: {ms:.3f} ms of device time ({card})")
    traced_steps(ss.run, "build/tools_trace/semi", 2, card, "semi step", r.device_ms)
    del ss
    torch.cuda.empty_cache()
    lap("profile_semi_torch and its trace")

    pcfg = profile_spsedt_torch.spsedt_config()
    sp = profile_spsedt_torch.spsedt_setup(pcfg, dev)
    reset_launch_counts()
    r = measure(sp.run, n, dev)
    check_tool_launches("profile_spsedt_torch", tools_counts(total), r.calls)
    check_tool_reading("SP-SEDT step", r)
    print(f"profile_spsedt_torch batch=200 patches=10 E=6 D=6 dtype=bfloat16: {r.ms:.3f} ms "
          f"({200 / r.ms * 1e3:.0f} clips/s); device {r.device_ms:.3f} ms ({card})")
    traced_steps(sp.run, "build/tools_trace/spsedt", 2, card, "SP-SEDT step", r.device_ms)
    lap("profile_spsedt_torch and its trace")

    ds = bench_spsedt_bank_torch.make_dataset(pcfg, 4 * bench_spsedt_bank_torch.B)
    reset_launch_counts()
    res = bench_spsedt_bank_torch.bench(sp, ds, bench_spsedt_bank_torch.STEPS,
                                        TOOLS_BANK_REPEATS)
    check_tool_launches("bench_spsedt_bank_torch", tools_counts(total), res["steps"])
    clips = bench_spsedt_bank_torch.STEPS * bench_spsedt_bank_torch.B
    print(f"bench_spsedt_bank_torch: losses equal over {bench_spsedt_bank_torch.STEPS} steps "
          f"({res['losses'][0][0]:.4f} .. {res['losses'][0][-1]:.4f}) ({card})")
    for name, ts in res["seconds"].items():
        assert all(math.isfinite(t) and t > 0 for t in ts), (name, ts)
        print(f"  {name}: {min(ts):.3f} s for {clips} clips, {clips / min(ts):.1f} clips/s "
              f"({card})")
    del sp, ds
    torch.cuda.empty_cache()
    lap("bench_spsedt_bank_torch")

    return {"counts": total, "flagship_trace_ms": flagship["device_ms_per_step"]}


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
    profile(lambda: infer(waves), "long predict", card, "long_predict_profile.txt")
    return {sq: n for (sq, _), n in seen.items()}


# --------------------------------------------------------------- profile


def profile(fn, label: str, card: str, file_name: str, once: bool = False) -> Recording:
    """``utils.profiler.record`` of ``fn``: the device's busy and idle share
    of the window printed, its table written to the output directory."""
    rec = record(fn, once)
    n = rec.calls
    print(f"profiled {n} x {label}: device busy {rec.busy_ms:.3f} ms each in "
          f"{sum(r[2] for r in rec.rows) // n} kernels and copies, {rec.wall_ms / n:.3f} ms "
          f"each wall under the profiler, idle share {1 - rec.busy_ms * n / rec.wall_ms:.4f} "
          f"({card})")
    lines = [f"{t / n / 1e3:10.4f} ms each {c // n:6d} each  {k[:140]}" for k, t, c in rec.rows]
    for line in lines[:12]:
        print("  " + line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / file_name).write_text(f"{card}\n" + "\n".join(lines) + "\n\n" + rec.table)
    return rec


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
            f"{'+dec_at' if m.dec_at else ''} slots {m.max_events} input {m.max_frames}x{m.n_mels} batch {batch} "
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
    worst = patch_crop_against_cpu(dev, SEED)
    print(f"SP-SEDT patch crop, card vs CPU: ok, max |difference| {worst:.3g}")
    worst = small_spsedt_step(dev, SEED)
    print(f"tiny f32 SP-SEDT step, 2 steps, card vs CPU: ok, max |loss or parameter difference| "
          f"{worst:.3g}")
    worst = small_semi_step(dev, SEED)
    print(f"tiny f32 semi step, 2 steps, card vs CPU: ok, max |loss or parameter difference| "
          f"{worst:.3g}")
    worst = small_semi_trainer(dev)
    print(f"tiny f32 semi trainer, 2 epochs, card vs CPU: ok, max |loss mean, count, threshold "
          f"or F1 difference| {worst:.3g}")
    worst = small_audio_tag_step(dev, SEED)
    print(f"tiny f32 audio-tag step, 2 steps, card vs CPU: ok, each update Adam's to 1e-3 of "
          f"the lr, max |loss difference| {worst:.3g}")
    worst = small_audio_tag_trainer(dev)
    print(f"tiny f32 audio-tag trainer, 2 epochs, card vs CPU: ok, max |loss mean or F1 "
          f"difference| {worst:.3g}")

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
    profile(lambda: step(batches[0], valid), "eval step", card, "eval_step_profile.txt")
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

    # 4e. SP-SEDT: the recipe's bare step at batch 200
    spsedt = run_spsedt_step_phase(dev, card, latency, clock_hz)
    errs["K1"] = max(errs["K1"], spsedt["err"])
    torch.cuda.empty_cache()

    # 4e'. the graphed train step against the eager one at both SEDT cells' widths
    run_graph_phase(dev, card)
    torch.cuda.empty_cache()

    # 4f. audio tags -> SP-SEDT pretrain -> fine-tune -> semi at full width on a DCASE layout
    chain = run_spsedt_chain_phase(dev, card)
    torch.cuda.empty_cache()

    # 4g. the semi step at the README recipe's width, batch 64
    semi = run_semi_step_phase(dev, card, latency, clock_hz)
    errs["K1"] = max(errs["K1"], semi["err"])
    torch.cuda.empty_cache()

    # 4h. the audio-tag step at the README's AT command, batch 64
    at_step = run_audio_tag_step_phase(dev, card)
    torch.cuda.empty_cache()

    # 4h'. AST's audio-tag step at the published widths, batch 64: K4 and its backward
    ast_step = run_ast_step_phase(dev, card)
    torch.cuda.empty_cache()

    # 4i. the train step over several processes: DDP at world 1 (NCCL), 2 ranks (gloo)
    multi = run_multiprocess_phase(dev, card, clock_hz, latency, errs["K1"])
    torch.cuda.empty_cache()

    # 4j. the train step under tensor parallel: 1 x 2 and the dryrun at 2 x 2 (gloo)
    tp = run_tensor_parallel_phase(dev, card, clock_hz, latency, errs["K1"])
    torch.cuda.empty_cache()

    # 4k. the measuring tools at their JAX counterparts' geometries
    tools = run_tools_phase(dev, card)

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
    timing["K4 backward"] = time_k4_backward(dev, card)

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
        {"name": "K1 lsap_lane SP-SEDT", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": spsedt["shape"], "launches": spsedt["launches"],
         "launches_pretrain_chain": chain["pretrain"],
         "launches_fine_tune_chain": chain["fine_tune"],
         "variant": "warp, 1 column a lane", "max_abs_err": errs["K1"], **spsedt["timing"]},
        {"name": "K1 lsap_lane semi", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": semi["shape"], "launches": semi["launches"],
         "launches_semi_chain": chain["semi"],
         "variant": "warp, 1 column a lane", "max_abs_err": errs["K1"], **semi["timing"]},
        {"name": "K1 lsap_lane train step, 2 ranks", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": multi["shape"], "launches": sum(multi["launches"]),
         "launches_per_rank": multi["launches"], "variant": "warp, 1 column a lane",
         "max_abs_err": errs["K1"], **multi["timing"]},
        {"name": "K1 lsap_lane train step, 1 x 2 tensor parallel", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": tp["shape"], "launches": sum(tp["launches"]),
         "launches_per_rank": tp["launches"], "variant": "warp, 1 column a lane",
         "max_abs_err": errs["K1"], **tp["timing"]},
        {"name": "K1 lsap_lane train step, 2 x 2 tensor parallel", "source": hungarian_src,
         "replaces": PALLAS_DIR + "hungarian.py:302", "tpu_kernel": "_jv_lane_kernel",
         "shape": tp["shape_2x2"], "launches": sum(tp["launches_2x2"]),
         "launches_per_rank": tp["launches_2x2"], "variant": "warp, 1 column a lane",
         "max_abs_err": errs["K1"], **tp["timing_2x2"]},
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
    # K4's backward replaces no TPU kernel (the JAX package recomputes through
    # a custom_vjp); on the main path in AST's training step (phase 4h'), one
    # call for each K4 launch, 12 a step
    kernels.append(
        {"name": "K4 flash_attention_backward AST", "source": SOURCE_DIR + "flash_attention.cu",
         "replaces": None, "tpu_kernel": None,
         "shape": {"q": list(AST_K4), "kv": list(AST_K4), "dtype": "bfloat16"},
         "launches": ast_step["K4 backward"], "launches_ast_steps": AST_STEPS,
         "variant": "tensor: flash_bwd_dot, flash_bwd_dkdv, flash_bwd_dq",
         "max_rel_err": errs["K4 backward"], **timing["K4 backward"]})
    for kernel in kernels:
        # the ResNet audio-tag step and trainer run no kernel of the four (asserted above)
        key = "K4 backward" if "backward" in kernel["name"] else kernel["name"].split()[0]
        kernel.update(route="cuda", parity="ok", launches_audio_tag_step=at_step[key],
                      launches_audio_tag_chain=chain["audio_tag"][key],
                      launches_tools=tools["counts"][key])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
