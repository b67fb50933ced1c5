"""Dropout drawn from an explicit ``torch.Generator``.

flax ``nn.Dropout`` semantics: in train mode each element is kept with
probability 1 - p and scaled by 1 / (1 - p); in eval mode, or at p = 0,
the module is the identity.  The mask comes from the generator that
:func:`seed_dropout` attaches (the trainers attach theirs), never from
torch's global RNG: a module in train mode with p > 0 and no generator
raises.  The two frameworks draw different bits from the same seed, so
parity tests run with p = 0.

Under data parallelism each data rank draws its own masks over its own
rows, from a generator seeded by :func:`rank_seed` (JAX draws one mask
over the global batch: the one departure of the port's multi-process
training from JAX's).  The ranks of one data index (a tensor-parallel
row) share the seed, so their replicated activations stay equal.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p
        self.generator: torch.Generator | None = None

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "call seed_dropout(model, generator)")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def seed_dropout(module: nn.Module, generator: torch.Generator) -> None:
    """Attach ``generator`` to every :class:`Dropout` inside ``module``."""
    for mod in module.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def rank_seed(seed: int, data_rank: int) -> int:
    """The dropout seed of data rank ``data_rank``: ``seed`` itself at
    rank 0 (a one-process run draws what it always drew), a distinct
    64-bit seed elsewhere."""
    return (seed + (data_rank << 32)) % (1 << 64)
