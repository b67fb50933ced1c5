"""The GFE-Mamba classifier head (counterpart of ``CrossMambaBoth`` in
``gfe_mamba_tpu/models/fusion.py``): tabular tokens + CLS + generator
feature tokens -> Mamba -> mean-pool -> cross-attention over the slice
tokens of [MRI, PET] -> GEGLU feed-forward -> LayerNorm + Linear logit."""

from __future__ import annotations

from typing import Sequence

import torch

from gfe_mamba_torch.models.attention import CrossAttention
from gfe_mamba_torch.models.ft_transformer import (FeedForward, LogitsHead,
                                                   TabularEmbedder,
                                                   flatten_volume_condition)
from gfe_mamba_torch.models.mamba import Mamba, MambaConfig


class _FusionBase(TabularEmbedder):
    """Embedding plus the shared cross-attention head.  ``d_cross`` is the
    slice-token width H*W of the conditioning volumes (25600 at
    160x160); ``cross_ff_dropout`` is the head feed-forward's dropout."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, heads: int, d_cross: int, dim_out: int = 1,
                 cross_ff_dropout: float = 0.1):
        super().__init__(categories, num_continuous, dim)
        self.final_cross = CrossAttention(heads, dim, d_cross)
        self.final_feed = FeedForward(dim, mult=2, dropout=cross_ff_dropout)
        self.to_logits = LogitsHead(dim, dim_out)

    def _fuse_head(self, x: torch.Tensor,
                   image_condition: Sequence[torch.Tensor]) -> torch.Tensor:
        x = x.mean(dim=1, keepdim=True)
        cond = flatten_volume_condition(image_condition).to(x.dtype)
        x = self.final_cross(x, cond) + x
        x = self.final_feed(x) + x
        return self.to_logits(x[:, 0])


class CrossMambaBoth(_FusionBase):
    """The GFE-Mamba classifier head with a ``depth``-layer Mamba mixer."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int,
                 dim_out: int = 1, cross_ff_dropout: float = 0.1):
        super().__init__(categories, num_continuous, dim, heads, d_cross,
                         dim_out, cross_ff_dropout)
        self.transformer = Mamba(MambaConfig(d_model=dim, n_layers=depth))

    def forward(self, x_categ: torch.Tensor, x_numer: torch.Tensor,
                feature_img: torch.Tensor,
                image_condition: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.embed(x_categ, x_numer)
        x = torch.cat([x, feature_img.to(x.dtype)], dim=1)
        return self._fuse_head(self.transformer(x), image_condition)
