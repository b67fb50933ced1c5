"""Device values handed to the host per training step: the program's
``gfe.sync.*`` spans (one per ``to_host`` call) in the window over the
steps."""

from portbench.metrics.program_spans import count_per_item


def read(run):
    if not run.traffic.get("train"):
        return None
    return count_per_item(run, "gfe.sync.")
