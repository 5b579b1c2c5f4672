"""``issue_ms_per_step``: the host's mean ms in the ``train.step`` span over
the window, unprofiled: the Python of the step and autograd issuing its
kernels, which return before the device runs them.  Prints each span's ms a
step over the window on standard error."""

from .. import spans


def read(run):
    spans.report_window(run)
    return spans.mean_ms(run, "train.step")
