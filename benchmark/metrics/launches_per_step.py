"""``launches_per_step``: kernel records in the profiled stretch over its
steps."""

from .. import trace as tr


def read(run):
    t = run.get("trace")
    if t is None or not t.device:
        return None
    return len(tr.kernels(t)) / t.steps
