"""``k1_roofline``: kernel K1's least time by bytes (its f32 cost tensor
read once and its assignment written once, at the cell's shape:
:func:`benchmark.flops.k1_bytes`) over its mean device time a launch in the
profiled stretch, in percent.  Bytes alone bound it: how many operations an
assignment takes depends on the data and the algorithm."""

import re

from .. import flops
from .. import trace as tr

K1 = re.compile(r"jv_warp_kernel<\s*1\s*[,>]")


def read(run):
    launches = tr.find(run.get("trace"), K1)
    if not launches:
        return None
    mean_s = sum(e.dur for e in launches) / len(launches) / 1e6
    least_s = flops.k1_bytes(run["config"], run["traffic"]["batch"]) / run["config"]["peak_bytes_per_s"]
    return 100.0 * least_s / mean_s
