"""Dropout drawn from an explicit ``torch.Generator``.

flax ``nn.Dropout`` semantics: in train mode each element is kept with
probability 1 - p and scaled by 1 / (1 - p); in eval mode, or at p = 0,
the module is the identity.  ``broadcast_dims`` draws one bit for every
index of the other dims and shares it along these (flax's argument of
that name: a segmentation ``SingleConv``'s ``'D'`` drops whole channels).
The mask comes from the generator that :func:`seed_dropout` attaches
(the trainers attach theirs), never from torch's global RNG: a module in
train mode with p > 0 and no generator raises.  The two frameworks draw
different bits from the same seed, so parity tests against JAX run with
p = 0.

Under data parallelism every rank holds a generator seeded alike and
draws the mask of the whole global batch, ``data_size`` times its own
rows, then keeps its own rows (the mesh's ``data_index``): the masks are
those one process draws over the global batch, as JAX draws one mask
over its global batch, and the generators stay in step across ranks.  Dim 0
is the batch in every tensor a dropout sees.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float = 0.0, broadcast_dims: tuple = ()):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        if 0 in broadcast_dims:
            raise ValueError("dropout cannot broadcast over the batch dim")
        self.p = p
        self.broadcast_dims = tuple(broadcast_dims)
        self.generator: torch.Generator | None = None
        self.data_index, self.data_size = 0, 1

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "call seed_dropout(model, generator)")
        rows = x.shape[0]
        shape = [1 if d in self.broadcast_dims else n
                 for d, n in enumerate(x.shape)]
        shape[0] = rows * self.data_size
        draw = torch.rand(shape, generator=self.generator, device=x.device)
        keep = draw[self.data_index * rows:(self.data_index + 1) * rows] \
            >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def seed_dropout(module: nn.Module, generator: torch.Generator,
                 mesh=None) -> None:
    """Attach ``generator`` to every :class:`Dropout` inside ``module``;
    ``mesh`` (``parallel/mesh.py``) names this rank's rows of the global
    batch by its data index and size (module docstring)."""
    index, size = (0, 1) if mesh is None else (mesh.data_index,
                                               mesh.data_size)
    for mod in module.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
            mod.data_index, mod.data_size = index, size
