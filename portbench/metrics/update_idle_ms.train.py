"""Device-idle time per training step while the program's ``gfe.update``
spans are open (the update): the spans merged, less the part in which
some device operation runs (``program_spans.idle_ms_per_item``)."""

from portbench.metrics.program_spans import idle_ms_per_item


def read(run):
    if not run.traffic.get("train"):
        return None
    return idle_ms_per_item(run, "gfe.update")
