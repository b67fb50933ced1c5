"""Model FLOP utilisation while answering: the routed model's operations
over the traced window's requests (products, the depthwise conv and the
attention's two products, the MoE at its top-2 experts only; counted by
``portbench.jamba_work.jamba_ops``) over the window, as a share of the
configuration's peak."""

from portbench.metrics.docqa import window_work


def read(run):
    work = window_work(run)
    if work is None:
        return None
    flops = sum(w.flops for w in work)
    return 100.0 * flops / run.trace.window_s / run.peak_flops
