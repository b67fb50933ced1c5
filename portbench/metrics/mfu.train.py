"""Model FLOP utilisation of a training step: the step's operations
(a trained part forward and backward, a frozen part its forward and the
input gradients that flow through it; ``portbench.work``) over the
traced window's time per step, as a share of the configuration's peak."""

from portbench.work import total


def read(run):
    if not run.traffic.get("train") or not run.items:
        return None
    flops = total(run.driver.ops(), step=True) * run.items
    return 100.0 * flops / run.trace.window_s / run.peak_flops
