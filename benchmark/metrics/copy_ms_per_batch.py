"""``copy_ms_per_batch``: the mean ms of the ``predict.copy`` span over the
window: one batch of pageable waveforms copied to the device, on the host
clock."""

from .. import spans


def read(run):
    return spans.mean_ms(run, "predict.copy")
