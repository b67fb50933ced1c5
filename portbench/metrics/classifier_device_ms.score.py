"""Device time per request of the operations launched inside the
benchmark's ranges around ``model.combiner`` and ``model.classifier``."""


def read(run):
    if run.traffic["entry"] != "score" or not run.items:
        return None
    return run.trace.device_s_in("pb.classifier") * 1e3 / run.items
