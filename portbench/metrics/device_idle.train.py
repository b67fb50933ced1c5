"""The share of the traced window in which no operation runs on the
device, over training steps (see ``device_idle.score``)."""


def read(run):
    if not run.traffic.get("train"):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
