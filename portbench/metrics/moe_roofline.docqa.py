"""The routed experts' least time over their device time in the
prefills.  Per MoE call the larger of the top-2 experts' operations over
the peak rate and the bytes of the experts it uses (their weights once,
the routed tokens in and out) over the memory bandwidth
(``portbench.jamba_work.jamba_ops``), summed over the window's prefills; the
device time is that of everything launched while the program's
``gfe.moe.experts`` spans are open inside its ``gfe.prefill`` spans
(grouping by expert, the products, the gated sum).  The decode steps
replay a CUDA graph, whose layers open no span."""

from portbench.metrics.docqa import device_s_launched_in_both, least_s


def read(run):
    least = least_s(run, "experts", "prefill")
    if least is None:
        return None
    device_s = device_s_launched_in_both(run, "gfe.moe.experts",
                                         "gfe.prefill")
    return 100.0 * least / device_s if device_s else None
