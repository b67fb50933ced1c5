"""FT-Transformer pieces the fusion head uses (counterpart of part of
``gfe_mamba_tpu/models/ft_transformer.py``).  flax defaults hold:
LayerNorm eps 1e-6, tanh-approximated GELU."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout

LN_EPS = 1e-6   # flax nn.LayerNorm default
NUM_SPECIAL_TOKENS = 2   # embedding rows ahead of the first category


class GEGLU(nn.Module):
    """x, gates = split(x); x * gelu(gates)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gates = x.chunk(2, dim=-1)
        return x * F.gelu(gates, approximate="tanh")


class FeedForward(nn.Sequential):
    """LN -> Linear(2*mult*dim) -> GEGLU -> Dropout -> Linear(dim), the
    weights at the reference indices 0, 1, 4."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__(nn.LayerNorm(dim, eps=LN_EPS),
                         nn.Linear(dim, dim * mult * 2), GEGLU(),
                         Dropout(dropout), nn.Linear(dim * mult, dim))


class NumericalEmbedder(nn.Module):
    """Per-feature affine lift of ``(B, n)`` scalars to ``(B, n, dim)``."""

    def __init__(self, dim: int, num_numerical_types: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(num_numerical_types, dim))
        self.biases = nn.Parameter(torch.empty(num_numerical_types, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., None] * self.weights + self.biases


def category_offsets(categories: Sequence[int],
                     num_special_tokens: int) -> np.ndarray:
    """Exclusive cumulative offsets so each categorical column indexes its
    own slice of the shared embedding table."""
    if len(categories) > 1:
        return np.concatenate(
            [[num_special_tokens],
             num_special_tokens + np.cumsum(np.asarray(categories[:-1]))]
        ).astype(np.int64)
    return np.asarray([num_special_tokens], np.int64)


class TabularEmbedder(nn.Module):
    """Categorical + numerical token embedding with a CLS token in front.

    The fusion heads subclass it, so its parameters sit at the top of
    their state_dict (``cls_token``, ``categorical_embeds.weight``,
    ``numerical_embedder.weights``) as in the reference."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int):
        super().__init__()
        self.num_categories = len(categories)
        num_unique = int(sum(categories))
        self.category_offsets = tuple(
            category_offsets(categories, NUM_SPECIAL_TOKENS).tolist())
        self.categorical_embeds = None
        if num_unique > 0:
            self.categorical_embeds = nn.Embedding(
                num_unique + NUM_SPECIAL_TOKENS, dim)
        self.numerical_embedder = NumericalEmbedder(dim, num_continuous) \
            if num_continuous > 0 else None
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))

    def embed(self, x_categ: torch.Tensor,
              x_numer: torch.Tensor) -> torch.Tensor:
        if x_categ.shape[-1] != self.num_categories:
            raise ValueError(f"expected {self.num_categories} categorical "
                             f"columns, got {x_categ.shape[-1]}")
        b = x_categ.shape[0]
        xs = [self.cls_token.expand(b, -1, -1)]
        if self.categorical_embeds is not None:
            offsets = torch.tensor(self.category_offsets,
                                   device=x_categ.device)
            xs.append(self.categorical_embeds(x_categ.long() + offsets))
        if self.numerical_embedder is not None:
            xs.append(self.numerical_embedder(
                x_numer.to(self.cls_token.dtype)))
        return torch.cat(xs, dim=1)


def flatten_volume_condition(volumes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Channels-last volumes ``(B, H, W, D, C)`` -> slice tokens
    ``(B, sum(D*C), H*W)``: ``b h w d c -> b (d c) (h w)`` of each."""
    toks = []
    for v in volumes:
        b, h, w, d, c = v.shape
        toks.append(v.reshape(b, h * w, d * c).transpose(1, 2))
    return torch.cat(toks, dim=1)


class LogitsHead(nn.Sequential):
    """LayerNorm -> Linear(dim_out), at the reference indices 0, 1."""

    def __init__(self, dim: int, dim_out: int = 1):
        super().__init__(nn.LayerNorm(dim, eps=LN_EPS),
                         nn.Linear(dim, dim_out))
