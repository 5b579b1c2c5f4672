"""``attn_backward_ms_per_step``: the device time a step of the
``attention.backward`` ranges (K4's backward: the recompute of the plain
attention and its gradient) in the profiled stretch, ms: each range's span
on the device's timeline (the trace's ``gpu_user_annotation``), summed over
the stretch and divided by its steps.  The entry reads the ranges from its
trace file into the window (``gpu_ranges_ms_per_step``); a program without
the span gives none."""


def read(run):
    return run["window"].get("gpu_ranges_ms_per_step", {}).get("attention.backward")
