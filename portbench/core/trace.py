"""The traced run: ranges that the benchmark opens around the calls into
each layer, ``torch.profiler`` (CPU + CUDA) over the measured window,
and the reduction of its events to what the per-layer readers read.

Ranges are ``record_function`` spans named ``pb.<layer>``, opened and
closed by forward pre- and post-hooks that the benchmark registers on
the program's modules; nothing is added inside the program.  A device
operation (kernel, copy or fill) belongs to a range when the host call
that launched it lies inside that range on the same thread, whatever
the kernel's name.  ``pb.window`` spans the measured window and
``pb.item`` each request or step.

``conv_modules`` marks every module that holds exactly one 3x3x3 conv
weight: its range is ``pb.conv3d`` and its pre-hook counts the conv's
operations and bytes from the shapes it is called with
(:func:`portbench.work.conv3d_work`)."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

from portbench.work import conv3d_work

NAME = 160   # characters of an operation's name kept in the breakdown


class Ranges:
    """Forward hooks that open ``pb.<name>`` around modules;
    ``conv_flops`` and ``conv_bytes`` add up the conv work seen while
    ``counting``."""

    def __init__(self):
        self.handles = []
        self.open = []
        self.counting = False
        self.conv_flops = 0
        self.conv_bytes = 0

    def around(self, module, name: str, on_call=None):
        def pre(mod, args, kwargs):
            if on_call is not None and self.counting:
                on_call(mod, args, kwargs)
            rf = record_function(f"pb.{name}")
            rf.__enter__()
            self.open.append(rf)

        def post(mod, args, kwargs, out):
            self.open.pop().__exit__(None, None, None)

        self.handles.append(module.register_forward_pre_hook(
            pre, with_kwargs=True))
        self.handles.append(module.register_forward_hook(
            post, with_kwargs=True))

    def conv_modules(self, model):
        """Ranges around every module holding exactly one 3x3x3 conv
        weight; a holder that is never called opens none."""
        for mod in model.modules():
            weights = [p for p in mod.parameters()
                       if p.dim() == 5 and tuple(p.shape[2:]) == (3, 3, 3)]
            if len(weights) == 1:
                self.around(mod, "conv3d", self._count(weights[0]))

    def _count(self, weight):
        def count(mod, args, kwargs):
            x = args[0]
            residual = kwargs.get("residual")
            flops, nbytes = conv3d_work(tuple(x.shape), tuple(weight.shape),
                                        x.element_size(),
                                        residual is not None)
            self.conv_flops += flops
            self.conv_bytes += nbytes
        return count

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles.clear()


def union(intervals):
    """Merged ``[start, end)`` intervals of ``intervals`` (sorted)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, lo, hi):
    """Length of ``merged`` inside ``[lo, hi]``."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


class Trace:
    """The reduced events of one profiled window, times in ns.

    ``device``: ``(start, end, name, launch time, launch thread)`` of each
    device operation; ``spans``: ``{name: {thread: (starts, merged
    spans)}}`` of the ``pb.`` ranges; ``host``: the CPU events of the
    window's thread as ``(start, end, name)``, sorted."""

    def __init__(self, events):
        launches, device, user, host = {}, [], [], []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CPU:
                if not e.is_user_annotation():
                    device.append(e)
                continue
            s, d, tid = e.start_ns(), e.duration_ns(), e.start_thread_id()
            if e.linked_correlation_id():
                # a runtime or driver call, linked to the op that made it
                launches[e.correlation_id()] = (s, tid)
            if e.is_user_annotation() and e.name().startswith("pb."):
                user.append((e.name(), s, s + d, tid))
            host.append((s, s + d, e.name(), tid))
        window = [u for u in user if u[0] == "pb.window"]
        if len(window) != 1:
            raise RuntimeError(f"{len(window)} pb.window ranges in the trace")
        _, self.w0, self.w1, self.thread = window[0]
        ranges = defaultdict(lambda: defaultdict(list))
        for name, s, e, tid in user:
            ranges[name][tid].append((s, e))
        # each name's spans on a thread, merged: (starts, merged spans)
        self.spans = {name: {tid: (lambda m: ([s for s, _ in m], m))(
            union(spans)) for tid, spans in by_thread.items()}
            for name, by_thread in ranges.items()}
        self.device = []
        for e in device:
            s = e.start_ns()
            launch = launches.get(e.correlation_id(), (None, None))
            self.device.append((s, s + e.duration_ns(), e.name(), *launch))
        self.host = sorted((s, e, n) for s, e, n, tid in host
                           if tid == self.thread)
        self.merged = union([(s, e) for s, e, *_ in self.device])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return covered(self.merged, self.w0, self.w1) / 1e9

    def _inside(self, name, t, tid) -> bool:
        starts, merged = self.spans.get(name, {}).get(tid, ((), ()))
        if t is None or not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]

    def device_s_in(self, *names) -> float:
        """Seconds of device operations launched inside any range of
        ``names`` (each operation once, its time clipped to the window)."""
        ops = [(max(s, self.w0), min(e, self.w1))
               for s, e, _, t, tid in self.device
               if any(self._inside(n, t, tid) for n in names)]
        return sum(max(0, e - s) for s, e in ops) / 1e9

    def device_ops(self, top=10):
        by = defaultdict(int)
        for s, e, name, *_ in self.device:
            by[name] += max(0, min(e, self.w1) - max(s, self.w0))
        worst = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:NAME], ns / 1e9] for name, ns in worst if ns > 0]

    def idle_gaps(self, top=10):
        """Idle time of the device inside the window, summed by the
        innermost host event open at each gap's middle."""
        by = defaultdict(int)
        starts = [h[0] for h in self.host]
        prev = self.w0
        for s, e in self.merged + [[self.w1, self.w1]]:
            s, e = max(s, self.w0), min(e, self.w1)
            if s > prev:
                by[self._innermost(starts, (prev + s) // 2)] += s - prev
            prev = max(prev, e)
        worst = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:NAME], ns / 1e9] for name, ns in worst]

    def _innermost(self, starts, t) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            s, e, name = self.host[i]
            if e >= t:
                return name
            i -= 1
        return "(no host event)"


class Profiler:
    """``torch.profiler`` over CPU and CUDA with no shapes, stacks or
    memory; ``stop`` returns the :class:`Trace`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=False, with_stack=False,
                            profile_memory=False)

    def start(self):
        self.prof.start()

    def stop(self) -> Trace:
        self.prof.stop()
        return Trace(self.prof.profiler.kineto_results.events())
