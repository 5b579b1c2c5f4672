"""``idle_issue_ms_per_step``: the profiled stretch's device-idle time that
overlaps the ``train.step`` ranges, in ms a step: the card waiting on the
host's issue of the step."""

from .. import spans


def read(run):
    parts = spans.idle_parts(run.get("trace"))
    return None if parts is None else parts["issue"] / 1e3 / run["trace"].steps
