"""K2's least time over its device time in the prefills: its bytes (x,
delta, z in and y out in the served dtype, B, C, D and the bias, A and
the last state in float32; ``portbench.jamba_work.jamba_ops``) over the memory
bandwidth, over the device time of what is launched while the program's
``gfe.scan`` spans are open."""

from portbench.metrics.docqa import least_s
from portbench.metrics.program_spans import device_ms_launched_in


def read(run):
    least = least_s(run, "scan", "prefill")
    device_ms = device_ms_launched_in(run, "gfe.scan")
    if least is None or not device_ms:
        return None
    return 100.0 * least / (device_ms * run.items / 1e3)
