"""``clips_per_s``: every clip of every step completed in the window, over
the window's whole time on the host clock (ended by a synchronise)."""


def read(run):
    w = run["window"]
    return w["clips"] / w["window_s"] if w["steps"] else None
