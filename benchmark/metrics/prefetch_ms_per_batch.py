"""``prefetch_ms_per_batch``: the prefetch thread's mean ms in the
``data.batch`` span over the window: one batch's targets or patch boxes,
collate and pin, on the host clock."""

from .. import spans


def read(run):
    return spans.mean_ms(run, "data.batch")
