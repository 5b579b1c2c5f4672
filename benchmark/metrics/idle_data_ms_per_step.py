"""``idle_data_ms_per_step``: the profiled stretch's device-idle time that
overlaps ``train.gather`` and every ``train.wait`` but the stretch's first,
in ms a step: the card waiting on the batches."""

from .. import spans


def read(run):
    parts = spans.idle_parts(run.get("trace"))
    return None if parts is None else parts["data"] / 1e3 / run["trace"].steps
