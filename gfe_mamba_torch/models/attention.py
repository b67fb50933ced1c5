"""Self- and cross-attention (counterpart of
``gfe_mamba_tpu/models/attention.py``), as einsum plus softmax.  The
projections and the einsums compute in their operands' promoted dtype
(``models/promote.py``): under the bf16 cast, f32 queries over bf16
keys and values take their logits and output in f32, as JAX's do."""

from __future__ import annotations

import torch
from torch import nn

from gfe_mamba_torch.models.promote import Linear, promote


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``b n (h d) -> b h n d``."""
    b, n, _ = t.shape
    return t.reshape(b, n, n_heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """``b h n d -> b n (h d)``."""
    b, _, n, _ = t.shape
    return t.transpose(1, 2).reshape(b, n, -1)


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention of ``x (B, n, d_embed)`` with
    an optional causal mask."""

    def __init__(self, n_heads: int, d_embed: int, in_proj_bias: bool = True,
                 out_proj_bias: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_embed // n_heads
        self.in_proj = Linear(d_embed, 3 * d_embed, bias=in_proj_bias)
        self.out_proj = Linear(d_embed, d_embed, bias=out_proj_bias)

    def forward(self, x: torch.Tensor,
                causal_mask: bool = False) -> torch.Tensor:
        q, k, v = (_heads(t, self.n_heads)
                   for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum("bhid,bhjd->bhij", q, k) / self.d_head ** 0.5
        if causal_mask:
            n = x.shape[1]
            mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
        out = torch.einsum("bhij,bhjd->bhid", torch.softmax(logits, -1), v)
        return self.out_proj(_merge(out))


class CrossAttention(nn.Module):
    """Multi-head attention of ``x (B, n, d_embed)`` over
    ``y (B, m, d_cross)``, as einsum plus softmax."""

    def __init__(self, n_heads: int, d_embed: int, d_cross: int):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_embed // n_heads
        self.q_proj = Linear(d_embed, d_embed)
        self.k_proj = Linear(d_cross, d_embed)
        self.v_proj = Linear(d_cross, d_embed)
        self.out_proj = Linear(d_embed, d_embed)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.n_heads) for t in promote(
            self.q_proj(x), self.k_proj(y), self.v_proj(y)))
        logits = torch.einsum("bhid,bhjd->bhij", q, k) / self.d_head ** 0.5
        out = torch.einsum("bhij,bhjd->bhid", torch.softmax(logits, -1), v)
        return self.out_proj(_merge(out))
