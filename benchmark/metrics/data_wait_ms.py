"""``data_wait_ms``: the mean wait of a step for its batch over the window,
the ``StepTimer`` data time that ``train_one_epoch`` returns."""


def read(run):
    w = run["window"]
    return 1e3 * w["data_wait_s"] / w["data_waits"] if w["data_waits"] else None
