"""``k4_roofline``: kernel K4's least time at the cell's ``[B, H, N, D]``
(:func:`benchmark.flops_ast.k4_least_s`: the larger of its two products'
operations at the bf16 peak and q, k, v and the output in bf16 at the
memory's peak) over its mean device time a forward launch
(``flash_mma_kernel``) in the profiled stretch, in percent."""

import re

from .. import flops_ast
from .. import trace as tr

K4 = re.compile(r"flash_mma_kernel")


def read(run):
    launches = tr.find(run.get("trace"), K4)
    if not launches:
        return None
    mean_s = sum(e.dur for e in launches) / len(launches) / 1e6
    return 100.0 * flops_ast.k4_least_s(run["config"], run["traffic"]["batch"]) / mean_s
