"""``setup_s``: the harness's start to the window's start: the clips, the
weights, the bank, the kernels' build (on a checkout's first run) and the
check steps, which warm every shape the window runs."""


def read(run):
    return run["setup_s"]
