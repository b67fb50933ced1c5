"""Device time per request of the operations launched inside the
benchmark's range around ``model.generator``."""


def read(run):
    if run.traffic["entry"] != "score" or not run.items:
        return None
    return run.trace.device_s_in("pb.generator") * 1e3 / run.items
