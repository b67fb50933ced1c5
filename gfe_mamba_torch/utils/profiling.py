"""Tracing and profiling hooks (counterpart of
``gfe_mamba_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` session (host, and the card
  when there is one) whose trace goes to ``logdir`` through the
  TensorBoard trace handler, as JAX's ``jax.profiler`` trace does.
* ``annotate(name, args)``: a named span in that trace
  (``record_function``) while a profiler runs on the calling thread, and
  one shared no-op context otherwise, so an untraced run pays a flag
  read (~0.25 us) per span and no ``record_function`` (~11 us).  The
  program's spans are all ``gfe.*``: the trainers' ``gfe.step`` with its
  ``gfe.forward``, ``gfe.backward``, ``gfe.update`` and ``gfe.sync.*``;
  the pipeline's ``gfe.generator`` and ``gfe.classifier``; the ops'
  ``gfe.conv3d`` (``.dz`` / ``.dw`` in the backward) and ``gfe.scan``
  (``.bwd``).  They land in the same trace as the device's operations,
  on one clock.
* ``to_host(x, site)``: a device value handed to the host (``float``, or
  ``bool`` for a flag) inside the span ``gfe.sync.<site>``; every host
  synchronisation of the trainers goes through it.
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
from torch.autograd.profiler import record_function


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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, args: str | None = None):
    """A span ``name`` (with ``args``) of the trace running on this
    thread; the shared no-op context when none runs.  The profiler's flag
    is thread-local: autograd's device thread sees it, a thread the
    program starts does not."""
    if torch.autograd._profiler_enabled():
        return record_function(name, args)
    return _NO_SPAN


def to_host(x, site: str):
    """``x`` (a one-element tensor, or a number) on the host, ``bool``
    for a boolean tensor and ``float`` otherwise, inside the span
    ``gfe.sync.<site>``: the host waits here for the device's queue up
    to ``x``."""
    with annotate(f"gfe.sync.{site}"):
        if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
            return bool(x)
        return float(x)


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
