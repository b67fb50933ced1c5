"""The share of the traced window in which no operation runs on the
device: the union of the device operations' intervals, not a sum of
their times."""


def read(run):
    if run.traffic["entry"] != "docqa":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
