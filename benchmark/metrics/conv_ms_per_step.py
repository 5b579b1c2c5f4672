"""``conv_ms_per_step``: device ms a step of the kernels of kind
"convolution" (:data:`benchmark.trace.KERNEL_KINDS`) in the profiled
stretch."""

from .. import trace as tr


def read(run):
    t = run.get("trace")
    if t is None or not t.device:
        return None
    return tr.kind_ms_per_step(t).get("convolution")
