"""Device time per training step of the operations launched while the
program's ``gfe.backward`` spans are open.  Autograd's device thread
launches the backward's kernels while the calling thread waits inside
``gfe.backward``, so a launch counts by its time, from any thread."""

from portbench.metrics.program_spans import device_ms_launched_in


def read(run):
    if not run.traffic.get("train"):
        return None
    return device_ms_launched_in(run, "gfe.backward")
