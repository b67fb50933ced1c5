"""Image-to-image ViT bottleneck (counterpart of
``gfe_mamba_tpu/models/vit.py``), channels-last images ``(B, H, W, C)``.

Submodules carry the reference names (``to_patch_embedding.2``,
``transformer.layers.3.0.to_qkv``, ``from_patch_embedding.4``).  flax
defaults hold throughout: LayerNorm eps 1e-6 and tanh-approximated GELU.
Dropout sits where the JAX ViT has it (attention map, attention output,
both feed-forward layers, embeddings) and is active in train mode only.
"""

from __future__ import annotations

import torch
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout

LN_EPS = 1e-6   # flax nn.LayerNorm default


class Patchify(nn.Module):
    """``b (h p1) (w p2) c -> b (h w) (p1 p2 c)``."""

    def __init__(self, patch: int):
        super().__init__()
        self.patch = patch

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        b, height, width, c = img.shape
        p = self.patch
        x = img.reshape(b, height // p, p, width // p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(
            b, (height // p) * (width // p), p * p * c)


class SwapTokens(nn.Module):
    """``b n d <-> b d n``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2)


class Attention(nn.Module):
    """Pre-norm multi-head self-attention (``ViTAttention``).  The softmax
    is the submodule ``attend`` (no parameters), where
    ``vit_zoo_final.record_attention`` hooks the maps, as the reference's
    Recorder hooks ``attend`` and JAX sows them."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.attend = nn.Softmax(dim=-1)
        self.attn_drop = Dropout(dropout)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), Dropout(dropout)) \
            if project_out else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.to_qkv(self.norm(x))
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        attn = self.attend(
            torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head ** -0.5)
        out = torch.einsum("bhij,bhjd->bhid", self.attn_drop(attn), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout
    (``ViTFeedForward``), the weights at the reference's ``net`` indices
    0, 1, 4."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS), nn.Linear(dim, hidden_dim),
            nn.GELU(approximate="tanh"), Dropout(dropout),
            nn.Linear(hidden_dim, dim), Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Transformer(nn.Module):
    """Residual attention/feed-forward stack with a final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dim_head, dropout),
                           FeedForward(dim, mlp_dim, dropout)])
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return self.norm(x)


class ImageToImageViT(nn.Module):
    """ViT mapping a ``(B, H, W, C)`` feature image to one of the same
    shape: patchify, embed, prepend CLS, transformer, then a token-mixing
    Linear(n+1 -> n) that drops CLS, un-embed and un-patchify."""

    def __init__(self, image_size: tuple[int, int], channels: int,
                 patch_size: int = 40, dim: int = 512, depth: int = 4,
                 heads: int = 6, mlp_dim: int = 2048, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0):
        super().__init__()
        height, width = image_size
        p = patch_size
        if height % p or width % p:
            raise ValueError(f"image dims {image_size} must be divisible by "
                             f"patch {p}")
        self.grid = (height // p, width // p)
        self.patch = p
        num_patches = self.grid[0] * self.grid[1]
        patch_dim = channels * p * p
        self.to_patch_embedding = nn.Sequential(
            Patchify(p), nn.LayerNorm(patch_dim, eps=LN_EPS),
            nn.Linear(patch_dim, dim), nn.LayerNorm(dim, eps=LN_EPS))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.from_patch_embedding = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS), SwapTokens(),
            nn.Linear(num_patches + 1, num_patches), SwapTokens(),
            nn.Linear(dim, patch_dim), nn.LayerNorm(patch_dim, eps=LN_EPS))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        b, c = img.shape[0], img.shape[-1]
        x = self.to_patch_embedding(img)
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        x = self.from_patch_embedding(self.transformer(self.dropout(x)))
        (h, w), p = self.grid, self.patch
        x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h * p, w * p, c)

