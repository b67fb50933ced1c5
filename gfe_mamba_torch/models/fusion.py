"""The GFE-Mamba classifier heads (counterpart of
``gfe_mamba_tpu/models/fusion.py``): tabular tokens + CLS + generator
feature tokens -> sequence mixer (Mamba or Jamba) -> mean-pool ->
cross-attention over the slice tokens of [MRI, PET] -> GEGLU
feed-forward -> LayerNorm + Linear logit.

``d_cross`` is the slice-token width H*W of the conditioning volumes
(25600 at 160x160); with ``d_cross=None`` a head has no cross-attention
and feed-forward and runs without the image condition.

The generator's feature tokens join the table's with ``torch.cat``,
which promotes as ``jnp.concatenate`` does: under the bf16 cast with an
f32 ``x_numer`` the mixer and the head run in f32
(``models/promote.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

from gfe_mamba_torch.models.ft_transformer import TabularHead
from gfe_mamba_torch.models.jamba import Jamba, JambaConfig
from gfe_mamba_torch.models.mamba import Mamba, MambaConfig


class _FusionBase(TabularHead):
    """The mixed sequence is mean-pooled into the head."""

    def _fuse_head(self, x: torch.Tensor, image_condition) -> torch.Tensor:
        return self.head(x.mean(dim=1, keepdim=True), image_condition)


class CrossMambaBoth(_FusionBase):
    """The GFE-Mamba classifier head with a ``depth``-layer Mamba mixer."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int | None,
                 dim_out: int = 1, cross_ff_dropout: float = 0.1):
        super().__init__(categories, num_continuous, dim, heads, d_cross,
                         dim_out, cross_ff_dropout=cross_ff_dropout)
        self.transformer = Mamba(MambaConfig(d_model=dim, n_layers=depth))

    def forward(self, x_categ: torch.Tensor, x_numer: torch.Tensor,
                feature_img: torch.Tensor,
                image_condition: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
        x = self.embed(x_categ, x_numer)
        x = torch.cat([x, feature_img], dim=1)
        return self._fuse_head(self.transformer(x), image_condition)


class CrossJambaBoth(_FusionBase):
    """The Jamba-mixer head: ``2 * depth`` layers of width ``dim``, MLPs
    of ``2 * dim``, ``heads`` attention heads (layer 4 is the first
    attention layer), ``num_experts`` experts top-``num_experts_per_tok``
    on the odd layers.  The router logits are dropped: no load-balancing
    term enters the Stage-2 loss."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int | None,
                 dim_out: int = 1, attn_dropout: float = 0.0,
                 cross_ff_dropout: float = 0.1, num_experts: int = 16,
                 num_experts_per_tok: int = 2):
        super().__init__(categories, num_continuous, dim, heads, d_cross,
                         dim_out, cross_ff_dropout=cross_ff_dropout)
        self.transformer = Jamba(JambaConfig(
            d_model=dim, n_layers=2 * depth, mlp_size=2 * dim,
            num_attention_heads=heads, attention_dropout=attn_dropout,
            num_experts=num_experts,
            num_experts_per_tok=num_experts_per_tok))

    def forward(self, x_categ: torch.Tensor, x_numer: torch.Tensor,
                feature_img: torch.Tensor,
                image_condition: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
        x = self.embed(x_categ, x_numer)
        x = torch.cat([x, feature_img], dim=1)
        return self._fuse_head(self.transformer(x)[0], image_condition)


class CrossMambaAblation(CrossMambaBoth):
    """The ablation harness: the Mamba head with optional paths.
    ``no_table`` keeps the CLS token and drops the table tokens (it needs
    ``feature_img``); ``feature_img=None`` runs without the generator's
    tokens; ``image_condition=None`` without the cross-attention."""

    def forward(self, x_categ: torch.Tensor, x_numer: torch.Tensor,
                feature_img: torch.Tensor | None = None,
                image_condition: Sequence[torch.Tensor] | None = None,
                no_table: bool = False) -> torch.Tensor:
        x = self.embed(x_categ, x_numer)
        if no_table:
            if feature_img is None:
                raise ValueError("no_table needs the image feature tokens")
            x = x[:, :1]
        if feature_img is not None:
            x = torch.cat([x, feature_img], dim=1)
        return self._fuse_head(self.transformer(x), image_condition)
