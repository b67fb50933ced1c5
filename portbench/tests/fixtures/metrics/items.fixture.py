"""A metric that only a test adds: the items in the traced window."""


def read(run):
    return float(run.items) if run.items else None
