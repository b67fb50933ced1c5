"""Failure detection and recovery (counterpart of
``gfe_mamba_tpu/training/resilience.py``).

* ``StrikeCounter``: aborts after ``max_strikes`` consecutive skipped
  (non-finite) steps; a silent-NaN run is worse than a crash.
* ``AutoResume``: periodic full-train-state snapshots in ``keep``
  rotating slots, newest first on restore, so a crash replays at most
  ``interval`` steps.

JAX's ``finite_guard`` wraps a functional step; the port's trainers skip
a non-finite step in place (``training/classify_trainer.py``,
``training/gan_trainer.py``), so it has no counterpart here.
"""

from __future__ import annotations

from typing import Any

from gfe_mamba_torch.training.checkpoint import Checkpointer


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
    ``auto_0 .. auto_<keep-1>`` in turn; ``restore_latest`` returns the
    one with the highest step."""

    def __init__(self, directory: str, interval: int = 500, keep: int = 2):
        self.ckpt = Checkpointer(directory)
        self.interval = interval
        self.keep = keep
        self._slot = 0

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.interval):
            return False
        self.ckpt.save(f"auto_{self._slot}", {"step": step, "state": state})
        self._slot = (self._slot + 1) % self.keep
        return True

    def restore_latest(self, map_location=None):
        """``(step, state)`` of the newest snapshot, or ``(0, None)``."""
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
