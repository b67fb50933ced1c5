"""Model FLOP utilisation while scoring: the forward's operations
(convolutions and matrix products, counted from the configuration's
shapes by ``portbench.work``) over the traced window's time per request,
as a share of the configuration's peak."""

from portbench.work import total


def read(run):
    if run.traffic["entry"] != "score" or not run.items:
        return None
    flops = total(run.driver.ops(), step=False) * run.items
    return 100.0 * flops / run.trace.window_s / run.peak_flops
