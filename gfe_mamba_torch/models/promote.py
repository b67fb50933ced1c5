"""flax's dtype promotion for the classifier heads' layers.

The JAX package's layers have ``dtype=None``, so flax's
``promote_dtype`` makes each compute in the promoted dtype of its input
and its parameters.  Under the trainers' bf16 cast an f32 activation
therefore meets a bf16 weight in f32, and a bf16 activation stays in
bf16: in the Stage-2 step the f32 ``x_num`` promotes the numerical
tokens, the token sequence and so every layer after them to f32, while
the volumes' keys and values stay bf16.

``torch.cat`` and the elementwise ops promote by themselves;
``F.linear``, the convolutions, ``F.layer_norm`` and ``torch.einsum``
refuse mixed dtypes, so they take their operands through
:func:`promote`.  The layers below are ``nn`` modules with that one
change: same parameters, same state_dict keys."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def promote(*tensors):
    """``tensors`` cast to their promoted dtype (``torch.promote_types``
    over all of them, whatever their ranks).  ``None`` passes; a tensor
    already in that dtype comes back as it is, so a view stays a view."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors if t is not None))
    return [None if t is None else t.to(dtype) for t in tensors]


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, weight, bias, self.eps)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*promote(x, self.weight, self.bias))
