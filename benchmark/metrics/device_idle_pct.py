"""``device_idle_pct``: the share of the profiled stretch in which the
device runs nothing: one minus the union of its kernels, copies and sets
over the stretch's span, both from the trace (``busy_s`` and ``window_s``
of the result's ``device``).  The stretch is one call of the trainer's loop,
its start and end included, and the profiler's own host work slows the issue
of a host-paced step: both count here as idle."""

from .. import trace as tr


def read(run):
    t = run.get("trace")
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(t) / t.window_s)
