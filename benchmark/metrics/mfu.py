"""``mfu``: the analytic FLOPs of the steps completed in the window
(:func:`benchmark.flops.step_flops`: convolutions and matrix products,
forward and backward) over the window's seconds times the configuration's
dense bf16 peak, in percent."""

from .. import flops


def read(run):
    w = run["window"]
    if not w["steps"]:
        return None
    work = flops.step_flops(run["config"], run["traffic"]["batch"]) * w["steps"]
    return 100.0 * work / (w["window_s"] * run["config"]["peak_flops_per_s"])
