"""Device time per request of the operations launched while the
program's ``gfe.prefill`` span (``JambaLM.prefill``: the prompt's
parallel forward, filling the caches) is open."""

from portbench.metrics.program_spans import device_ms_launched_in


def read(run):
    if run.traffic["entry"] != "docqa":
        return None
    return device_ms_launched_in(run, "gfe.prefill")
