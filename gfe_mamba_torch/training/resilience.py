"""Failure detection and recovery (counterpart of
``gfe_mamba_tpu/training/resilience.py``).

* ``StrikeCounter``: aborts after ``max_strikes`` consecutive skipped
  (non-finite) steps; a silent-NaN run is worse than a crash.
* ``AutoResume``: periodic full-train-state snapshots in ``keep``
  rotating slots, newest first on restore, so a crash replays at most
  ``interval`` steps; with ``async_save`` the snapshots go through an
  ``AsyncCheckpointManager`` (written in the background, the ``keep``
  newest steps retained).  In a multi-process run only the ``writer``
  (rank 0 by default) writes, and every rank restores.

JAX's ``finite_guard`` wraps a functional step; the port's trainers skip
a non-finite step in place (``training/classify_trainer.py``,
``training/gan_trainer.py``), so it has no counterpart here.
"""

from __future__ import annotations

from typing import Any

from gfe_mamba_torch.training.checkpoint import (AsyncCheckpointManager,
                                                 Checkpointer)


class StrikeCounter:
    def __init__(self, max_strikes: int = 10):
        self.max_strikes = max_strikes
        self.consecutive = 0

    def update(self, skipped: float) -> None:
        if skipped > 0:
            self.consecutive += 1
            if self.consecutive >= self.max_strikes:
                raise FloatingPointError(
                    f"{self.max_strikes} consecutive non-finite train "
                    "steps -- aborting instead of training on garbage")
        else:
            self.consecutive = 0


class AutoResume:
    """Snapshots every ``interval`` steps (or when forced) into slots
    ``auto_0 .. auto_<keep-1>`` in turn, or as steps of an
    ``AsyncCheckpointManager`` (``async_save``); ``restore_latest``
    returns the one with the highest step."""

    def __init__(self, directory: str, interval: int = 500, keep: int = 2,
                 async_save: bool = False, writer: bool | None = None):
        if writer is None:
            from gfe_mamba_torch.parallel.multihost import is_main_process
            writer = is_main_process()
        self.writer = writer
        self.manager = AsyncCheckpointManager(
            directory, max_to_keep=keep, writer=writer) if async_save \
            else None
        self.ckpt = None if async_save else Checkpointer(directory)
        self.interval = interval
        self.keep = keep
        self._slot = 0

    def due(self, step: int, force: bool = False) -> bool:
        """Whether :meth:`maybe_save` of ``step`` writes a snapshot."""
        return force or (step != 0 and step % self.interval == 0)

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not self.due(step, force):
            return False
        if self.manager is not None:
            self.manager.save(step, state)
        elif self.writer:
            self.ckpt.save(f"auto_{self._slot}",
                           {"step": step, "state": state})
        self._slot = (self._slot + 1) % self.keep
        return True

    def close(self) -> None:
        """Drain pending asynchronous writes."""
        if self.manager is not None:
            self.manager.close()

    def restore_latest(self, map_location=None):
        """``(step, state)`` of the newest snapshot, or ``(0, None)``;
        an asynchronous snapshot's tensors come back on the CPU."""
        if self.manager is not None:
            step = self.manager.latest_step()
            if step is None:
                return 0, None
            return step, self.manager.restore(step)
        best_step, best_state = 0, None
        for slot in range(self.keep):
            name = f"auto_{slot}"
            if not self.ckpt.exists(name):
                continue
            payload = self.ckpt.restore(name, map_location)
            if int(payload["step"]) >= best_step:
                best_step = int(payload["step"])
                best_state = payload["state"]
        return best_step, best_state
