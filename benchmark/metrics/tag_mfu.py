"""``tag_mfu``: the analytic FLOPs of the AST steps completed in the window
(:func:`benchmark.flops_ast.step_flops`: the patch convolution, the linear
layers and the two attention products, forward and backward, without K4's
recompute) over the window's seconds times the configuration's dense bf16
peak, in percent."""

from .. import flops_ast


def read(run):
    w = run["window"]
    if not w["steps"]:
        return None
    work = flops_ast.step_flops(run["config"], run["traffic"]["batch"]) * w["steps"]
    return 100.0 * work / (w["window_s"] * run["config"]["peak_flops_per_s"])
