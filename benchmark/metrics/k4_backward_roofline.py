"""``k4_backward_roofline``: kernel K4's backward's least time at the cell's
``[B, H, N, D]`` (:func:`least_s`: the larger of its five products'
operations at the bf16 peak and q, k, v, the output and its gradient read and
dq, dk and dv written in bf16, with two f32 row statistics, at the memory's
peak) over its mean device time a backward call: the summed time of every
``flash_bwd_`` kernel in the profiled stretch over the count of
``flash_bwd_dkdv_kernel`` launches (one a call), in percent.  A program
without the backward kernels gives none."""

import re

from .. import flops_ast
from .. import trace as tr

BACKWARD = re.compile(r"flash_bwd_")
ONCE_A_CALL = re.compile(r"flash_bwd_dkdv_kernel")
F32_BYTES = 4


def least_s(config, batch: int) -> float:
    """Seconds: ``chip_smoke.k4_backward_bound`` counts the same operations
    and bytes, and the two must stay equal."""
    b, h, n, d = flops_ast.k4_shape(config, batch)
    ops = 5 * 2 * b * h * n * n * d
    nbytes = 8 * b * h * n * d * flops_ast.BF16_BYTES + 2 * b * h * n * F32_BYTES
    return max(ops / config["peak_flops_per_s"], nbytes / config["peak_bytes_per_s"])


def read(run):
    calls = tr.find(run.get("trace"), ONCE_A_CALL)
    if not calls:
        return None
    busy_s = sum(e.dur for e in tr.find(run["trace"], BACKWARD)) / 1e6
    return 100.0 * least_s(run["config"], run["traffic"]["batch"]) * len(calls) / busy_s
