"""``step_ms_p90``: the 90th percentile of every step interval in the
window, each between the CUDA events recorded after consecutive steps (the
first from the window's start)."""

import numpy as np


def read(run):
    iv = run["window"]["intervals_ms"]
    return float(np.percentile(iv, 90)) if iv else None
