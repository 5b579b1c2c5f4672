"""Analytic operation and byte counts of the audio-tag cell's AST step and of
kernel K4 at the cell's shape, from the configuration's shapes alone.

FLOPs follow :mod:`benchmark.flops`'s rules: two per multiply-add of every
convolution and matrix product, the forward, and in the backward the input
gradient of each product whose input needs one and the weight gradient of
each weight.  Counted: the patch convolution (its input is data, so no
input gradient), the qkv, projection, fc1, fc2 and head linear layers and
the two attention products ``q k^T`` and ``p v`` (both operands need a
gradient).  Left out: K4's backward recompute of the forward products
(the step does that work, the model does not need it), normalisations,
softmax, GELU, the loss and Adam.

K4's forward at ``[B, H, N, D]``: ``4 B H N^2 D`` operations (the two
products), and q, k and v read once and the output written once in bf16.
"""
from __future__ import annotations

from typing import Dict, Tuple

BF16_BYTES = 2


def tokens(m: Dict) -> int:
    f = (m["n_mels"] - m["patch"]) // m["fstride"] + 1
    t = (m["frames"] - m["patch"]) // m["tstride"] + 1
    return f * t + 2


def step_flops(config: Dict, batch: int) -> int:
    """The analytic FLOPs of one training step of ``batch`` clips."""
    m = config["model"]
    n, d, ff = tokens(m), m["dim"], m["mlp"]
    patch = 2 * (n - 2) * d * m["patch"] ** 2  # forward; the weight gradient the same again
    linear = 2 * n * d * (3 * d + d + 2 * ff)  # qkv, proj, fc1, fc2 of one layer
    attention = 2 * 2 * n * n * d  # q k^T and p v over every head
    head = 2 * d * m["num_classes"]
    # each product's backward is twice its forward (both gradients), the
    # patch convolution's once (the weight's)
    per_clip = 2 * patch + 3 * (m["layers"] * (linear + attention) + head)
    return batch * per_clip


def k4_shape(config: Dict, batch: int) -> Tuple[int, int, int, int]:
    """K4's ``[B, H, N, D]`` in the cell's step."""
    m = config["model"]
    return batch, m["heads"], tokens(m), m["dim"] // m["heads"]


def k4_flops(config: Dict, batch: int) -> int:
    b, h, n, d = k4_shape(config, batch)
    return 4 * b * h * n * n * d


def k4_bytes(config: Dict, batch: int) -> int:
    b, h, n, d = k4_shape(config, batch)
    return 4 * b * h * n * d * BF16_BYTES


def k4_least_s(config: Dict, batch: int) -> float:
    """K4's least time at the cell's shape: the larger of its operations at
    the dense bf16 peak and its bytes at the memory's peak."""
    return max(k4_flops(config, batch) / config["peak_flops_per_s"],
               k4_bytes(config, batch) / config["peak_bytes_per_s"])
