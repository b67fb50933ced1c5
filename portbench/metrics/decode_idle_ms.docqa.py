"""Device-idle time per decode step: for each request, the stretch of
device time from the first to the last operation of its decode steps
(``portbench.metrics.docqa.decode_ops``: the replays of the decoding
graph, or the eager steps under ``gfe.decode``), less the part in which
some device operation runs; summed over the window and divided by its
decode steps.  It counts the device waiting on the host between and
inside the steps, which the span on the host cannot show: a replay
returns before its work runs."""

import bisect

from portbench.core.trace import covered
from portbench.metrics.docqa import decode_ops, decode_steps


def read(run):
    if run.traffic["entry"] != "docqa":
        return None
    requests, steps = decode_ops(run), decode_steps(run)
    if not requests or not steps:
        return None
    merged = run.trace.merged
    starts = [s for s, _ in merged]
    idle = 0
    for ops in requests:
        lo, hi = ops[0][0], max(e for _, e in ops)
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        j = bisect.bisect_left(starts, hi)
        idle += (hi - lo) - covered(merged[i:j], lo, hi)
    return idle / 1e6 / steps
