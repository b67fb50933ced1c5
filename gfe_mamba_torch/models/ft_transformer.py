"""FT-Transformer components and the tabular transformer models
(counterpart of ``gfe_mamba_tpu/models/ft_transformer.py``).  flax
defaults hold: LayerNorm eps 1e-6, tanh-approximated GELU.

The encoders keep the ViT's module layout (``layers.<i>.0`` the
attention with its projection at ``to_out.0``, ``layers.<i>.1.net`` the
feed-forward): the flax names of both are ``attn_<i>`` / ``ff_<i>``, so
one set of conversion rules (``utils/convert.py``) serves both.  A
model built with ``d_cross=None`` has no final cross-attention or
feed-forward, the tree flax builds when it is initialised without an
image condition.

Every layer computes in the promoted dtype of its input and its
parameters (``models/promote.py``), as the flax modules do: under the
trainers' bf16 cast an f32 ``x_numer`` makes the numerical tokens, and
so the whole token sequence, f32, while the categorical tokens and the
CLS token stay in their parameters' dtype and the volume condition
reaches the cross-attention's keys and values as it is."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.attention import CrossAttention, _heads, _merge
from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.promote import LayerNorm, Linear

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
        super().__init__(LayerNorm(dim, eps=LN_EPS),
                         Linear(dim, dim * mult * 2), GEGLU(),
                         Dropout(dropout), Linear(dim * mult, dim))


class FTAttention(nn.Module):
    """Pre-norm multi-head self-attention without biases; returns the
    output and the post-softmax map (dropout applies to the map the
    values see, not to the one returned)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Sequential(Linear(inner, dim, bias=False))

    def forward(self, x: torch.Tensor):
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        attn = torch.softmax(torch.einsum(
            "bhid,bhjd->bhij", q * self.dim_head ** -0.5, k), dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", self.attn_drop(attn), v)
        return self.to_out(_merge(out)), attn


class FTFeedForward(nn.Module):
    """:class:`FeedForward` under ``net``, the ViT feed-forward's place."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = FeedForward(dim, mult, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class FTTransformerEncoder(nn.Module):
    """Residual FTAttention / FeedForward stack."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            FTAttention(dim, heads, dim_head, attn_dropout),
            FTFeedForward(dim, dropout=ff_dropout)]) for _ in range(depth))

    def _block(self, i: int, x: torch.Tensor, attns: list) -> torch.Tensor:
        attn, ff = self.layers[i]
        out, a = attn(x)
        attns.append(a)
        x = out + x
        return ff(x) + x

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        attns = []
        for i in range(len(self.layers)):
            x = self._block(i, x, attns)
        return (x, torch.stack(attns)) if return_attn else x


class TransformerCross(FTTransformerEncoder):
    """The encoder with a cross-attention over ``condition (B, m,
    d_cross)`` ahead of each layer (``cross.<i>``, flax ``cross_<i>``)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 d_cross: int, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0):
        super().__init__(dim, depth, heads, dim_head, attn_dropout,
                         ff_dropout)
        self.cross = nn.ModuleList(CrossAttention(heads, dim, d_cross)
                                   for _ in range(depth))

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                return_attn: bool = False):
        attns = []
        for i, cross in enumerate(self.cross):
            x = cross(x, condition) + x
            x = self._block(i, x, attns)
        return (x, torch.stack(attns)) if return_attn else x


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
        # the offsets as a tensor on each device embed has run on; not a
        # buffer, so to_empty cannot leave it unfilled and the state_dict
        # keeps the reference's keys
        self._offsets: dict[torch.device, torch.Tensor] = {}
        self.categorical_embeds = None
        if num_unique > 0:
            self.categorical_embeds = nn.Embedding(
                num_unique + NUM_SPECIAL_TOKENS, dim)
        self.numerical_embedder = NumericalEmbedder(dim, num_continuous) \
            if num_continuous > 0 else None
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))

    def _device_offsets(self, device: torch.device) -> torch.Tensor:
        """``category_offsets`` as int64 on ``device``, copied there on the
        first call for it and kept: the host's copy waits for the stream
        to drain, so a copy per call would hold the host behind all the
        work queued before it.  Made outside inference mode, so a later
        training step may save the indices it makes for backward."""
        offsets = self._offsets.get(device)
        if offsets is None:
            with torch.inference_mode(False):
                offsets = torch.tensor(self.category_offsets, device=device)
            self._offsets[device] = offsets
        return offsets

    def embed(self, x_categ: torch.Tensor,
              x_numer: torch.Tensor) -> torch.Tensor:
        if x_categ.shape[-1] != self.num_categories:
            raise ValueError(f"expected {self.num_categories} categorical "
                             f"columns, got {x_categ.shape[-1]}")
        b = x_categ.shape[0]
        xs = [self.cls_token.expand(b, -1, -1)]
        if self.categorical_embeds is not None:
            xs.append(self.categorical_embeds(
                x_categ.long() + self._device_offsets(x_categ.device)))
        if self.numerical_embedder is not None:
            xs.append(self.numerical_embedder(x_numer))
        if len(xs) == 1:
            # no table: flax joins the CLS token to an empty f32 block
            xs.append(torch.zeros(b, 0, self.cls_token.shape[-1],
                                  device=self.cls_token.device))
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
    """LayerNorm -> (ReLU when ``relu``) -> Linear(dim_out), the weights
    at indices 0, 1 either way (flax ``LayerNorm_0``, ``Dense_0``)."""

    def __init__(self, dim: int, dim_out: int = 1, relu: bool = False):
        super().__init__(LayerNorm(dim, eps=LN_EPS),
                         Linear(dim, dim_out))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        return self[1](F.relu(x) if self.relu else x)


class TabularHead(TabularEmbedder):
    """The tabular embedding and the head a tabular model ends in: with
    ``d_cross`` (the slice-token width H*W of the conditioning volumes), a
    residual cross-attention of the pooled token over the slice tokens
    and a residual GEGLU feed-forward of twice the width
    (``cross_ff_dropout``); then :class:`LogitsHead`."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, heads: int, d_cross: int | None = None,
                 dim_out: int = 1, cross_ff_dropout: float = 0.1,
                 relu: bool = False):
        super().__init__(categories, num_continuous, dim)
        if d_cross is not None:
            self.final_cross = CrossAttention(heads, dim, d_cross)
            self.final_feed = FeedForward(dim, 2, cross_ff_dropout)
        self.to_logits = LogitsHead(dim, dim_out, relu)

    def head(self, x: torch.Tensor, image_condition=None) -> torch.Tensor:
        """``x (B, 1, dim)`` -> logits ``(B, dim_out)``; the cross-attention
        runs when ``image_condition`` (a list of channels-last volumes) is
        given."""
        if image_condition is not None:
            cond = flatten_volume_condition(image_condition)
            x = self.final_cross(x, cond) + x
            x = self.final_feed(x) + x
        return self.to_logits(x[:, 0])


class CrossTransformerBoth(TabularHead):
    """Table tokens + CLS + image feature tokens through an
    FT-Transformer encoder; the CLS token cross-attends over [MRI, PET]."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int | None,
                 dim_head: int = 16, dim_out: int = 1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 cross_ff_dropout: float = 0.1):
        super().__init__(categories, num_continuous, dim, heads, d_cross,
                         dim_out, cross_ff_dropout=cross_ff_dropout)
        self.transformer = FTTransformerEncoder(
            dim, depth, heads, dim_head, attn_dropout, ff_dropout)

    def forward(self, x_categ, x_numer, feature_img, image_condition=None):
        x = self.embed(x_categ, x_numer)
        x = torch.cat([x, feature_img], dim=1)
        return self.head(self.transformer(x)[:, :1], image_condition)


class CrossTransformer(CrossTransformerBoth):
    """One conditioning volume; its final feed-forward takes
    ``ff_dropout``, not ``cross_ff_dropout``, as the JAX model's does."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int | None,
                 dim_head: int = 16, dim_out: int = 1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__(categories, num_continuous, dim, depth, heads,
                         d_cross, dim_head, dim_out, attn_dropout,
                         ff_dropout, cross_ff_dropout=ff_dropout)

    def forward(self, x_categ, x_numer, feature_img, image_condition=None):
        return super().forward(
            x_categ, x_numer, feature_img,
            None if image_condition is None else [image_condition])


class FTTransformerCrossImg(TabularHead):
    """The CLS token cross-attends the one volume once (no residual, no
    feed-forward); ReLU head."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int,
                 dim_head: int = 16, dim_out: int = 1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__(categories, num_continuous, dim, heads, None,
                         dim_out, relu=True)
        self.transformer = FTTransformerEncoder(
            dim, depth, heads, dim_head, attn_dropout, ff_dropout)
        self.final_cross = CrossAttention(heads, dim, d_cross)

    def forward(self, x_categ, x_numer, feature_img, image_condition):
        x = self.embed(x_categ, x_numer)
        x = torch.cat([x, feature_img], dim=1)
        x = self.transformer(x)[:, :1]
        cond = flatten_volume_condition([image_condition])
        return self.to_logits(self.final_cross(x, cond)[:, 0])


class FTTransformer(TabularHead):
    """The table-only FT-Transformer classifier: embed -> encoder -> CLS
    -> LayerNorm + ReLU + Linear."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, dim_head: int = 16,
                 dim_out: int = 1, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0):
        super().__init__(categories, num_continuous, dim, heads, None,
                         dim_out, relu=True)
        self.transformer = FTTransformerEncoder(
            dim, depth, heads, dim_head, attn_dropout, ff_dropout)

    def forward(self, x_categ, x_numer):
        x = self.transformer(self.embed(x_categ, x_numer))
        return self.to_logits(x[:, 0])


class FTTransformerCross(TabularHead):
    """Table tokens only, a cross-attention over ``condition (B, m,
    d_cross)`` ahead of every encoder layer; ReLU head."""

    def __init__(self, categories: Sequence[int], num_continuous: int,
                 dim: int, depth: int, heads: int, d_cross: int,
                 dim_head: int = 16, dim_out: int = 1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__(categories, num_continuous, dim, heads, None,
                         dim_out, relu=True)
        self.transformer = TransformerCross(
            dim, depth, heads, dim_head, d_cross, attn_dropout, ff_dropout)

    def forward(self, x_categ, x_numer, condition, return_attn=False):
        out = self.transformer(self.embed(x_categ, x_numer), condition,
                               return_attn)
        x, attns = out if return_attn else (out, None)
        logits = self.to_logits(x[:, 0])
        return (logits, attns) if return_attn else logits
