"""The work of the traced window's requests of a ``docqa`` cell, counted
from the configuration's shapes (``portbench.jamba_work.jamba_ops``): request
``i`` of the window answers prompt ``i mod 8`` of the mix."""

from __future__ import annotations

import bisect

from portbench.core.trace import union
from portbench.metrics.program_spans import spans
from portbench.jamba_work import jamba_ops


def window_work(run):
    """Every :class:`~portbench.jamba_work.Work` of the window's requests; None
    outside a ``docqa`` cell or without a request."""
    if run.traffic["entry"] != "docqa" or not run.items:
        return None
    lengths = run.traffic["lengths"]
    per_length = {n: jamba_ops(run.config, n, run.traffic["new_tokens"])
                  for n in set(lengths)}
    return [w for i in range(run.items)
            for w in per_length[lengths[i % len(lengths)]]]


def least_s(run, part: str, phase: str):
    """The least time of the window's calls of ``part`` in ``phase``: each
    call's larger bound, summed."""
    work = window_work(run)
    if work is None:
        return None
    return sum(w.least_s(run.peak_flops, run.peak_bytes_per_s)
               for w in work if w.part == part and w.phase == phase)


def device_s_launched_in_both(run, name: str, outer: str):
    """Device seconds of the operations launched, from the window's
    thread, while a ``name`` span lies open inside an ``outer`` span."""
    tr = run.trace
    inner, around = spans(tr, name), spans(tr, outer)
    both = union([(max(a, c), min(b, d)) for a, b in inner
                  for c, d in around if max(a, c) < min(b, d)])
    starts = [lo for lo, _ in both]
    total = 0
    for s, e, _, t, _ in tr.device:
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= both[i][1]:
            total += max(0, min(e, tr.w1) - max(s, tr.w0))
    return total / 1e9


def decode_steps(run) -> int:
    """The window's ``gfe.decode`` spans: one per decode step."""
    tr = run.trace
    return sum(1 for s, _, n in tr.host
               if n == "gfe.decode" and tr.w0 <= s <= tr.w1)


def decode_ops(run):
    """The device operations of the decode steps, clipped to the window,
    as one list of ``(start, end)`` per request in device order: those
    launched while a ``gfe.decode`` span lies open (an eager step's), and
    those with no launch the trace links to a host operation (a replay of
    the decoding graph is no operator, and the profiler links the kernels
    it runs to none).  A request's list ends at the next operation of
    another kind (the next request's prefill, the answer's copy to the
    host).  None without a decode span."""
    tr = run.trace
    steps = spans(tr, "gfe.decode")
    if not steps or not run.items:
        return None
    starts = [s for s, _ in steps]

    def decode(t):
        if t is None:
            return True
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= steps[i][1]

    requests, current = [], []
    for s, e, _, t, _ in sorted(tr.device):
        if e <= tr.w0 or s >= tr.w1:
            continue
        if decode(t):
            current.append((max(s, tr.w0), min(e, tr.w1)))
        elif current:
            requests.append(current)
            current = []
    if current:
        requests.append(current)
    return requests
