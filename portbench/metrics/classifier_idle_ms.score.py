"""Device-idle time per request while the program's ``gfe.classifier``
span (the combiner and the classifier head) is open
(``program_spans.idle_ms_per_item``)."""

from portbench.metrics.program_spans import idle_ms_per_item


def read(run):
    if run.traffic["entry"] != "score":
        return None
    return idle_ms_per_item(run, "gfe.classifier")
