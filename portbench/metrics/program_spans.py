"""What the program's own spans say in a traced window.

``gfe_mamba_torch`` opens ``gfe.*`` spans (``utils/profiling.py::
annotate``) inside its trainers, its pipeline and its ops while a profiler
runs: ``gfe.step`` around a training step, holding ``gfe.forward``,
``gfe.backward``, ``gfe.update`` and one ``gfe.sync.<site>`` per value
handed to the host; ``gfe.generator`` and ``gfe.classifier`` around the
two layers of scoring.  They are host events of the window's thread
(``Trace.host``), on the device trace's clock.  A program without them
(an older one) gives no spans, and every reading here is then None."""

from __future__ import annotations

import bisect

from portbench.core.trace import covered, union


def spans(trace, name: str) -> list:
    """The merged intervals, clipped to the window, of the window
    thread's host events called ``name``."""
    return union([(max(s, trace.w0), min(e, trace.w1))
                  for s, e, n in trace.host
                  if n == name and e > trace.w0 and s < trace.w1])


def idle_ms_per_item(run, name: str):
    """Device-idle milliseconds per item while a ``name`` span is open:
    the spans' merged time less the part in which some device operation
    runs; None without such a span."""
    tr = run.trace
    merged = spans(tr, name)
    if not merged or not run.items:
        return None
    starts = [s for s, _ in tr.merged]
    idle = 0
    for lo, hi in merged:
        # the device intervals that can overlap [lo, hi]
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        j = bisect.bisect_left(starts, hi)
        idle += (hi - lo) - covered(tr.merged[i:j], lo, hi)
    return idle / 1e6 / run.items


def device_ms_launched_in(run, name: str):
    """Device milliseconds per item of the operations launched, from any
    thread, while a ``name`` span is open on the window's thread (each
    operation's time clipped to the window); None without such a
    span."""
    tr = run.trace
    merged = spans(tr, name)
    if not merged or not run.items:
        return None
    starts = [s for s, _ in merged]
    total = 0
    for s, e, _, t, _ in tr.device:
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= merged[i][1]:
            total += max(0, min(e, tr.w1) - max(s, tr.w0))
    return total / 1e6 / run.items


def count_per_item(run, prefix: str):
    """Host events starting with ``prefix`` that begin in the window, per
    item; None where the window holds no ``gfe.step``."""
    tr = run.trace
    if not run.items or not spans(tr, "gfe.step"):
        return None
    n = sum(1 for s, _, name in tr.host
            if name.startswith(prefix) and tr.w0 <= s <= tr.w1)
    return n / run.items
