"""Tracing and profiling hooks (counterpart of
``gfe_mamba_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` session (host, and the card
  when there is one) whose trace goes to ``logdir`` through the
  TensorBoard trace handler, as JAX's ``jax.profiler`` trace does.
* ``annotate(name)``: a named span in that trace (``record_function``).
* ``StepTimer``: wall-clock step times with an EMA and percentiles,
  for steady-state throughput without a profiler; its ``summary`` has
  JAX's keys.  Time on the host clock: synchronise the card inside the
  timed block when a step ends in asynchronous work.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; the trace is written into ``logdir`` when it
    ends (TensorBoard's ``*.pt.trace.json``).  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named span of the current trace (a no-op without one)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates step wall times; ``summary()`` reports mean/EMA/p50/p95
    and items/sec."""

    def __init__(self, ema: float = 0.9):
        self.ema_coef = ema
        self.ema = None
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record(time.perf_counter() - self._t0)
        return False

    def record(self, dt: float) -> None:
        """Count one step of ``dt`` seconds."""
        self.times.append(dt)
        self.ema = dt if self.ema is None else (
            self.ema_coef * self.ema + (1 - self.ema_coef) * dt)

    def summary(self, items_per_step: int = 1, skip_warmup: int = 1) -> dict:
        times = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": len(self.times),
            "mean_s": float(times.mean()),
            "ema_s": float(self.ema) if self.ema is not None else None,
            "p50_s": float(np.percentile(times, 50)),
            "p95_s": float(np.percentile(times, 95)),
            "items_per_sec": float(items_per_step / times.mean()),
        }
