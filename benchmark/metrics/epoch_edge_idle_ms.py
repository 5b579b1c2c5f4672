"""``epoch_edge_idle_ms``: the profiled stretch's device-idle ms that
overlap its first ``train.wait`` (the loop's start: the prefetch thread's
start and first batch) and its ``train.fetch`` (the meter's fetch at the
epoch's end).  The stretch is one call of the loop, so it holds one epoch
boundary.  Prints the stretch's idle parts on standard error."""

from .. import spans


def read(run):
    spans.report_idle(run.get("trace"))
    parts = spans.idle_parts(run.get("trace"))
    return None if parts is None else parts["edge"] / 1e3
