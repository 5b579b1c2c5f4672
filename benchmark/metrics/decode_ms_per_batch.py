"""``decode_ms_per_batch``: the mean ms of the ``predict.decode`` span over
the window: one batch's events decoded on the host (``BoxEncoder.
decode_strong`` at threshold 0.5), after the fetch of its outputs."""

from .. import spans


def read(run):
    return spans.mean_ms(run, "predict.decode")
