"""ViT zoo, final batch (counterpart of
``gfe_mamba_tpu/models/vit_zoo_final.py``): token-sampling, rotary and
packed ViTs, the self-supervised and adapter wrappers, MaxViT with
registers, and the introspection utilities.

Channels-last images ``(B, H, W, C)``; the JAX classes' fields and
defaults, with ``channels`` (and EsViTProjector's input ``dim``)
keyword-only after them, since flax infers them.  Shapes stay static as
in JAX: ATS keeps ``k + 1`` tokens per sampling layer with duplicates
zeroed and masked, NaViT reads host-packed fixed-length buffers and
returns a validity mask beside its logits.  Submodules keep the flax
names; ``utils/convert_zoo.py`` renames the few that flax names
automatically.

Random draws come from an explicit ``torch.Generator``, each in one
small method that tests replace with JAX's draws: ATS's Gumbel uniforms
(``_ATSAttention.uniforms``), SimMIM's masking (``SimMIM.masked_indices``)
and MP3's per-sample permutation (``MP3.permutation``).  ATS samples in
eval mode too, as the reference does, so its forward takes a generator.

``extract`` and ``record_attention`` are the reference's Extractor and
Recorder as functions over forward hooks: the named submodule's output,
and the post-softmax maps of every ``models/vit.py::Attention`` (its
``attend`` submodule).  Freezing MemoryAdapter's backbone is the caller's
``adapter.vit.requires_grad_(False)``, as masking the ``vit`` subtree of
the optimizer is in JAX.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit import LN_EPS, Attention, Transformer
from gfe_mamba_torch.models.vit_zoo import (Patches, _pair, _patch_embedding,
                                            _posemb_sincos_2d, _prepend,
                                            patchify)
from gfe_mamba_torch.models.vit_zoo_extra import ConvCL, _gelu, _ln
from gfe_mamba_torch.models.vit_zoo_hier import (_MBConv, _TokenFeedForward,
                                                 _attend, _grid, _heads,
                                                 _index_buffer, _merge,
                                                 _rel_bias_indices, _ungrid,
                                                 _unwindows, _windows)

_NEG = -1e9


def _ln_nobias(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, bias=False)


class _FinalFeedForward(nn.Module):
    """Pre-norm MLP (ats_vit.py:113-125 / mp3.py:36-48)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 bias: bool = True):
        super().__init__()
        self.norm = _ln(dim) if bias else _ln_nobias(dim)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop1(_gelu(self.fc1(self.norm(x))))
        return self.drop2(self.fc2(y))


# ---------------------------------------------------------------------------
# ATS-ViT (ats_vit.py)
# ---------------------------------------------------------------------------


def _ats_perturbed(attn: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   k: int, uniforms: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The Gumbel-perturbed log scores ``(B, k, N-1)`` of ATS's draws
    (ats_vit.py:48-92): the CLS row's attention weighted by the value
    norms, normalised, logged, masked; ``uniforms`` ``(B, k, N-1)`` are
    the Gumbel draws' uniforms.  Each draw takes the argmax of its row."""
    cls_attn = attn[:, :, 0, 1:]                          # (b, h, n-1)
    value_norms = v[:, :, 1:].norm(dim=-1)
    scores = torch.einsum("bhn,bhn->bn", cls_attn, value_norms)
    normed = scores / (scores.sum(dim=-1, keepdim=True) + eps)
    pseudo = torch.log(normed + eps)
    pseudo = torch.where(mask[:, 1:], pseudo, _NEG)
    pseudo = pseudo[:, None].expand(attn.shape[0], k, -1)
    return pseudo - torch.log(-torch.log(uniforms + eps) + eps)


def _ats_sample(attn: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                k: int, uniforms: torch.Tensor, eps: float = 1e-6):
    """Adaptive token sampling (ats_vit.py:48-109) at a static shape:
    ``(ids, new_mask)``, ids ``(B, k+1)`` with a leading 0 (the CLS row)
    and the sampled ids ascending in [1, N-1], duplicates zeroed and
    masked and pushed right (the reference's unique + right-pad)."""
    b = attn.shape[0]
    ids = _ats_perturbed(attn, v, mask, k, uniforms, eps).argmax(dim=-1) + 1
    ids = ids.sort(dim=-1).values
    dup = torch.cat([torch.zeros(b, 1, dtype=torch.bool, device=ids.device),
                     ids[:, 1:] == ids[:, :-1]], dim=1)
    ids = torch.where(dup, 0, ids)
    order = torch.where(ids == 0, torch.iinfo(torch.int32).max, ids) \
        .argsort(dim=-1, stable=True)
    ids = ids.gather(1, order)
    new_mask = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                     device=ids.device), ids != 0], dim=1)
    ids = torch.cat([torch.zeros_like(ids[:, :1]), ids], dim=1)
    return ids, new_mask


class _ATSAttention(nn.Module):
    """ats_vit.py:127-175: masked attention that subsamples its output
    rows to ``output_num_tokens`` (+ CLS) where it has more."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0,
                 output_num_tokens: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.output_num_tokens = output_num_tokens
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    @staticmethod
    def uniforms(shape, generator: torch.Generator, device) -> torch.Tensor:
        """The Gumbel draws' uniforms in [0, 1)."""
        return torch.rand(shape, generator=generator, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator):
        n = x.shape[1]
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head ** -0.5
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        attn = self.attn_drop(torch.softmax(torch.where(pair, dots, _NEG),
                                            -1))
        ids = None
        out_k = self.output_num_tokens
        if out_k is not None and n - 1 > out_k:
            u = self.uniforms((x.shape[0], out_k, n - 1), generator,
                              x.device)
            ids, mask = _ats_sample(attn, v, mask, out_k, u.to(x.dtype))
            attn = attn.gather(2, ids[:, None, :, None].expand(
                -1, self.heads, -1, n))
        out = _merge(torch.einsum("bhij,bhjd->bhid", attn, v))
        return self.out_drop(self.to_out(out)), mask, ids


class ATSViT(nn.Module):
    """ats_vit.py:215-262: a ViT whose token count shrinks layer by layer
    by adaptive token sampling; ``forward(img, generator)`` (the draws),
    with ``return_sampled_token_ids`` also the kept patch ids (-1 marks a
    padding slot, as in the reference)."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, max_tokens_per_depth: Sequence[int], heads: int,
                 mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        tokens = list(max_tokens_per_depth)
        if len(tokens) != depth or sorted(tokens, reverse=True) != tokens:
            raise ValueError("max_tokens_per_depth needs one non-increasing "
                             "count per layer")
        (h, w), (p1, p2) = _pair(image_size), _pair(patch_size)
        n = (h // p1) * (w // p2)
        self.depth = depth
        self.to_patch_embedding = _patch_embedding(
            p1 * p2 * channels, dim, Patches((p1, p2)))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.dropout = Dropout(emb_dropout)
        for i, out_k in enumerate(tokens):
            self.add_module(f"attn_{i}", _ATSAttention(
                dim, heads, dim_head, dropout, out_k))
            self.add_module(f"ff_{i}", _FinalFeedForward(dim, mlp_dim,
                                                         dropout))
        self.mlp_head_norm = _ln(dim)
        self.mlp_head_dense = nn.Linear(dim, num_classes)

    def forward(self, img: torch.Tensor, generator: torch.Generator,
                return_sampled_token_ids: bool = False):
        x = _prepend(self.cls_token, self.to_patch_embedding(img))
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        b, n = x.shape[:2]
        mask = torch.ones(b, n, dtype=torch.bool, device=x.device)
        token_ids = torch.arange(n, device=x.device).expand(b, n)
        rows = torch.arange(b, device=x.device)[:, None]
        for i in range(self.depth):
            out, mask, ids = getattr(self, f"attn_{i}")(x, mask, generator)
            if ids is not None:
                x, token_ids = x[rows, ids], token_ids[rows, ids]
            x = x + out
            x = getattr(self, f"ff_{i}")(x) + x
        logits = self.mlp_head_dense(self.mlp_head_norm(x[:, 0]))
        if return_sampled_token_ids:
            return logits, token_ids[:, 1:] - 1
        return logits


# ---------------------------------------------------------------------------
# Rotary ViT (rvt.py)
# ---------------------------------------------------------------------------


def _axial_rotary(n: int, dim_head: int, max_freq: float):
    """rvt.py:18-44: the 2D axial rotary sin and cos, ``(n * n,
    4 * (dim_head // 4))`` each, f32 from f64 numpy as JAX makes them."""
    scales = np.linspace(1.0, max_freq / 2, dim_head // 4)
    seq = np.linspace(-1.0, 1.0, n)[:, None] * scales[None, :] * np.pi
    x_sinu = np.broadcast_to(seq[:, None, :], (n, n, seq.shape[-1]))
    y_sinu = np.broadcast_to(seq[None, :, :], (n, n, seq.shape[-1]))
    sin = np.concatenate([np.sin(x_sinu), np.sin(y_sinu)], axis=-1)
    cos = np.concatenate([np.cos(x_sinu), np.cos(y_sinu)], axis=-1)
    # interleaved duplication: 'n d -> n (d j)', j=2
    sin, cos = (np.repeat(t.reshape(n * n, -1), 2, axis=-1)
                for t in (sin, cos))
    return sin.astype(np.float32), cos.astype(np.float32)


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


class _SpatialConv(nn.Module):
    """rvt.py:58-70: the query projection as a depthwise conv + pointwise
    Linear over the patch grid; the CLS token projected on its own where
    the widths differ."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int):
        super().__init__()
        self.dw = ConvCL(dim_in, dim_in, kernel, 1, kernel // 2,
                         groups=dim_in, bias=False)
        self.pw = nn.Linear(dim_in, dim_out, bias=False)
        self.cls_proj = nn.Linear(dim_in, dim_out) if dim_in != dim_out \
            else None

    def forward(self, x: torch.Tensor, fmap: int) -> torch.Tensor:
        cls_tok, tokens = x[:, :1], x[:, 1:]
        g = tokens.reshape(x.shape[0], fmap, -1, x.shape[-1])
        g = self.pw(self.dw(g)).flatten(1, 2)
        if self.cls_proj is not None:
            cls_tok = self.cls_proj(cls_tok)
        return torch.cat([cls_tok, g], dim=1)


class _RvTAttention(nn.Module):
    """rvt.py:91-153: rotary q and k (the CLS token and the dims past the
    table unrotated), depthwise-conv queries."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0, use_rotary: bool = True,
                 use_ds_conv: bool = True, conv_query_kernel: int = 5):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.use_rotary, self.use_ds_conv = use_rotary, use_ds_conv
        self.norm = _ln(dim)
        self.to_q = _SpatialConv(dim, inner, conv_query_kernel) \
            if use_ds_conv else nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                fmap: int) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.heads
        y = self.norm(x)
        q = self.to_q(y, fmap) if self.use_ds_conv else self.to_q(y)
        k, v = self.to_kv(y).chunk(2, dim=-1)
        q, k, v = (_heads(t, h).reshape(b * h, n, -1) for t in (q, k, v))
        if self.use_rotary:
            rot = sin.shape[-1]

            def rotary(t):
                body, rest = t[:, 1:, :rot], t[:, 1:, rot:]
                body = body * cos + _rotate_every_two(body) * sin
                return torch.cat([t[:, :1], torch.cat([body, rest], -1)], 1)

            q, k = rotary(q), rotary(k)
        dots = torch.einsum("bid,bjd->bij", q, k) * self.dim_head ** -0.5
        attn = self.attn_drop(torch.softmax(dots, -1))
        out = torch.einsum("bij,bjd->bid", attn, v).reshape(b, h, n, -1)
        return self.out_drop(self.to_out(_merge(out)))


class _GEGLUFeedForward(nn.Module):
    """rvt.py:72-89: LN -> Linear(2 * hidden) -> gelu(gates) * values ->
    Linear (a plain GELU MLP without ``use_glu``)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 use_glu: bool = True):
        super().__init__()
        self.use_glu = use_glu
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hidden_dim * (2 if use_glu else 1))
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc1(self.norm(x))
        if self.use_glu:
            val, gates = y.chunk(2, dim=-1)
            y = _gelu(gates) * val
        else:
            y = _gelu(y)
        return self.drop2(self.fc2(self.drop1(y)))


class RvT(nn.Module):
    """rvt.py:175-208: rotary vision transformer (CLS token, no position
    table)."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, dropout: float = 0.0,
                 use_rotary: bool = True, use_ds_conv: bool = True,
                 use_glu: bool = True, *, channels: int = 3):
        super().__init__()
        p = patch_size
        self.patch, self.fmap, self.depth = p, image_size // p, depth
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        sin, cos = _axial_rotary(self.fmap, dim_head, float(image_size))
        self.register_buffer("sin", torch.from_numpy(sin), persistent=False)
        self.register_buffer("cos", torch.from_numpy(cos), persistent=False)
        for i in range(depth):
            self.add_module(f"attn_{i}", _RvTAttention(
                dim, heads, dim_head, dropout, use_rotary, use_ds_conv))
            self.add_module(f"ff_{i}", _GEGLUFeedForward(dim, mlp_dim,
                                                         dropout, use_glu))
        self.mlp_head_norm = _ln(dim)
        self.mlp_head_dense = nn.Linear(dim, num_classes)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = _prepend(self.cls_token,
                     self.patch_embed(patchify(img, (self.patch,) * 2)))
        sin, cos = self.sin.to(x.dtype), self.cos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, sin, cos, self.fmap) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return self.mlp_head_dense(self.mlp_head_norm(x[:, 0]))


# ---------------------------------------------------------------------------
# NaViT (na_vit.py): packed multi-resolution batches
# ---------------------------------------------------------------------------


class _HeadRMSNorm(nn.Module):
    """na_vit.py:86-94: per-head RMS norm with a learned gamma, the
    attention scale folded in."""

    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.empty(heads, 1, dim))

    def reset_extra(self, generator: torch.Generator) -> None:
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
        return normed * self.dim ** 0.5 * self.gamma


class _NaViTAttention(nn.Module):
    """na_vit.py:108-160: bias-free LN, RMS-normed q and k, a key-padding
    and a pairwise mask, an optional (un-normed) context."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = _ln_nobias(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.q_norm = _HeadRMSNorm(heads, dim_head)
        self.k_norm = _HeadRMSNorm(heads, dim_head)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, context=None, mask=None,
                attn_mask=None) -> torch.Tensor:
        y = self.norm(x)
        kv_in = y if context is None else context
        q = self.q_norm(_heads(self.to_q(y), self.heads))
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(kv_in).chunk(2, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, self.k_norm(k))
        if mask is not None:
            dots = torch.where(mask[:, None, None, :], dots, _NEG)
        if attn_mask is not None:
            dots = torch.where(attn_mask, dots, _NEG)
        attn = self.attn_drop(torch.softmax(dots, -1))
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.out_drop(self.to_out(_merge(out)))


class NaViT(nn.Module):
    """na_vit.py:186-389, the packed core: ``forward(patches, positions,
    image_ids, mask)`` over buffers from :func:`pack_images` (``(B, L,
    c*p*p)``, ``(B, L, 2)`` patch coordinates, ``(B, L)`` image ids and
    key mask) returns ``(logits, valid)``: logits ``(B, max_images,
    num_classes)`` and which of those slots hold an image, in place of
    the reference's dynamic ``x[is_images]``."""

    def __init__(self, image_size, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 max_images: int = 4, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        h, w = _pair(image_size)
        p = patch_size
        self.depth, self.max_images = depth, max_images
        self.patch_norm1 = _ln_nobias(channels * p * p)
        self.patch_embed = nn.Linear(channels * p * p, dim)
        self.patch_norm2 = _ln_nobias(dim)
        self.pos_embed_height = nn.Parameter(torch.empty(h // p, dim))
        self.pos_embed_width = nn.Parameter(torch.empty(w // p, dim))
        self.emb_drop = Dropout(emb_dropout)
        for i in range(depth):
            self.add_module(f"attn_{i}", _NaViTAttention(dim, heads, dim_head,
                                                         dropout))
            self.add_module(f"ff_{i}", _FinalFeedForward(
                dim, mlp_dim, dropout, bias=False))
        self.final_norm = _ln_nobias(dim)
        self.attn_pool_queries = nn.Parameter(torch.empty(dim))
        self.attn_pool = _NaViTAttention(dim, heads, dim_head)
        self.mlp_head_norm = _ln_nobias(dim)
        self.mlp_head_dense = nn.Linear(dim, num_classes, bias=False)

    def forward(self, patches: torch.Tensor, positions: torch.Tensor,
                image_ids: torch.Tensor, mask: torch.Tensor):
        b = patches.shape[0]
        positions = positions.long()
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(patches)))
        x = x + self.pos_embed_height[positions[..., 0]] \
            + self.pos_embed_width[positions[..., 1]]
        x = self.emb_drop(x)
        same = image_ids[:, None, :, None] == image_ids[:, None, None, :]
        attn_mask = same & mask[:, None, None, :]
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, attn_mask=attn_mask) + x
            x = getattr(self, f"ff_{i}")(x) + x
        x = self.final_norm(x)
        # masked per-image attention pooling (na_vit.py:356-374)
        queries = self.attn_pool_queries.expand(b, self.max_images, -1)
        slots = torch.arange(self.max_images, device=x.device)
        pool_mask = (slots[None, :, None] == image_ids[:, None, :]) \
            & mask[:, None, :]
        pooled = self.attn_pool(queries, context=x,
                                attn_mask=pool_mask[:, None]) + queries
        logits = self.mlp_head_dense(self.mlp_head_norm(pooled))
        count = torch.where(mask, image_ids, -1).amax(dim=-1) + 1
        return logits, slots[None, :] < count[:, None]


def group_images_by_max_seq_len(
        images: List[np.ndarray], patch_size: int,
        calc_token_dropout: Optional[Callable] = None,
        max_seq_len: int = 2048) -> List[List[np.ndarray]]:
    """na_vit.py:31-70: greedy first-fit grouping of (h, w, c) images
    (host-side numpy)."""
    if calc_token_dropout is None:
        calc_token_dropout = (lambda h, w: 0.0)
    groups, group, seq_len = [], [], 0
    for image in images:
        ph, pw = (d // patch_size for d in image.shape[:2])
        n = int(ph * pw * (1 - calc_token_dropout(*image.shape[:2])))
        if n > max_seq_len:
            raise ValueError(f"an image of {n} tokens exceeds max_seq_len "
                             f"{max_seq_len}")
        if seq_len + n > max_seq_len:
            groups.append(group)
            group, seq_len = [], 0
        group.append(image)
        seq_len += n
    if group:
        groups.append(group)
    return groups


def pack_images(grouped: Sequence[Sequence[np.ndarray]], patch_size: int,
                max_seq_len: int, token_dropout_prob=None, seed: int = 0):
    """Host-side packer (na_vit.py:267-333): each group's images
    patchified (``(h p1) (w p2) c -> (h w) (c p1 p2)``) into one
    ``max_seq_len`` buffer with their patch coordinates, image ids and a
    key mask; token dropout keeps ``max(1, int(n * (1 - prob)))`` tokens
    of each image, chosen by ``np.random.default_rng(seed)`` (the JAX
    packer's draws, bitwise).  A dict of numpy arrays for
    :meth:`NaViT.forward`."""
    rng = np.random.default_rng(seed)
    if token_dropout_prob is None:
        calc_drop = None
    elif callable(token_dropout_prob):
        calc_drop = token_dropout_prob
    else:
        calc_drop = (lambda h, w: float(token_dropout_prob))
    p = patch_size
    c = grouped[0][0].shape[-1]
    b = len(grouped)
    patches = np.zeros((b, max_seq_len, c * p * p), np.float32)
    positions = np.zeros((b, max_seq_len, 2), np.int32)
    image_ids = np.zeros((b, max_seq_len), np.int32)
    mask = np.zeros((b, max_seq_len), bool)
    for gi, images in enumerate(grouped):
        offset = 0
        for image_id, image in enumerate(images):
            h, w = image.shape[:2]
            if h % p or w % p:
                raise ValueError(f"image {h}x{w} not divisible by the "
                                 f"patch {p}")
            ph, pw = h // p, w // p
            seq = image.reshape(ph, p, pw, p, c).transpose(0, 2, 4, 1, 3) \
                .reshape(ph * pw, c * p * p)
            pos = np.stack(np.meshgrid(np.arange(ph), np.arange(pw),
                                       indexing="ij"), axis=-1).reshape(-1, 2)
            if calc_drop is not None:
                keep = max(1, int(seq.shape[0] * (1 - calc_drop(h, w))))
                idx = rng.permutation(seq.shape[0])[:keep]
                seq, pos = seq[idx], pos[idx]
            n = seq.shape[0]
            if offset + n > max_seq_len:
                raise ValueError("a group overflows max_seq_len")
            patches[gi, offset:offset + n] = seq
            positions[gi, offset:offset + n] = pos
            image_ids[gi, offset:offset + n] = image_id
            mask[gi, offset:offset + n] = True
            offset += n
    return {"patches": patches, "positions": positions,
            "image_ids": image_ids, "mask": mask}


# ---------------------------------------------------------------------------
# SimMIM (simmim.py)
# ---------------------------------------------------------------------------


class SimMIM(nn.Module):
    """simmim.py:6-87: a random patch subset replaced by a mask token, the
    full sequence encoded, the masked patches L1-reconstructed; the loss
    divided by ``num_masked`` once more, as the reference does
    (simmim.py:86).  ``forward(img, generator)`` returns the loss."""

    def __init__(self, image_size, patch_size, dim: int, depth: int,
                 heads: int, mlp_dim: int, masking_ratio: float = 0.5,
                 dim_head: int = 64, *, channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        n = (h // self.patch[0]) * (w // self.patch[1])
        patch_dim = self.patch[0] * self.patch[1] * channels
        self.num_masked = int(masking_ratio * n)
        self.patch_norm1 = _ln(patch_dim)
        self.patch_embed = nn.Linear(patch_dim, dim)
        self.patch_norm2 = _ln(dim)
        # the table keeps the encoder's CLS row, as the reference's does
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.mask_token = nn.Parameter(torch.empty(dim))
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.to_pixels = nn.Linear(dim, patch_dim)

    @staticmethod
    def masked_indices(b: int, n: int, num_masked: int,
                       generator: torch.Generator, device) -> torch.Tensor:
        """The masked patches of each sample, ``(b, num_masked)``: the top
        ``num_masked`` of n uniforms."""
        draw = torch.rand(b, n, generator=generator, device=device)
        return draw.topk(num_masked, dim=1).indices

    def forward(self, img: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        patches = patchify(img, self.patch)
        b, n, _ = patches.shape
        tokens = self.patch_norm2(self.patch_embed(self.patch_norm1(patches)))
        pos = self.pos_embedding[:, 1:].to(tokens.dtype)
        idx = self.masked_indices(b, n, self.num_masked, generator,
                                  img.device)
        rows = torch.arange(b, device=img.device)[:, None]
        masked = torch.zeros(b, n, dtype=torch.bool, device=img.device)
        masked[rows, idx] = True
        tokens = torch.where(masked[..., None],
                             self.mask_token.to(tokens.dtype) + pos,
                             tokens + pos)
        pred = self.to_pixels(self.transformer(tokens)[rows, idx])
        return (pred - patches[rows, idx]).abs().mean() / self.num_masked


# ---------------------------------------------------------------------------
# MP3: masked position prediction (mp3.py)
# ---------------------------------------------------------------------------


class _MP3Attention(nn.Module):
    """mp3.py:50-89: x and the context normed by the same LayerNorm
    (mp3.py:75-77)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        y = self.norm(x)
        ctx = y if context is None else self.norm(context)
        q = _heads(self.to_q(y), self.heads)
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(ctx).chunk(2, dim=-1))
        out = _attend(q, k, v, self.attn_drop, scale=self.dim_head ** -0.5)
        return self.out_drop(self.to_out(_merge(out)))


class _MP3Transformer(nn.Module):
    """mp3.py:91-104: layers of (cross-)attention + feed-forward, no
    final norm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", _MP3Attention(dim, heads, dim_head,
                                                       dropout))
            self.add_module(f"ff_{i}", _FinalFeedForward(dim, mlp_dim,
                                                         dropout))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x, context) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


class MP3ViT(nn.Module):
    """mp3.py:106-146: a SimpleViT-like classifier (sincos positions, mean
    pool) whose transformer takes a cross-attention context."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        patch_dim = self.patch[0] * self.patch[1] * channels
        self.dim = dim
        self.patch_norm1 = _ln(patch_dim)
        self.patch_embed = nn.Linear(patch_dim, dim)
        self.patch_norm2 = _ln(dim)
        self.register_buffer("pos", _posemb_sincos_2d(
            h // self.patch[0], w // self.patch[1], dim), persistent=False)
        self.transformer = _MP3Transformer(dim, depth, heads, dim_head,
                                           mlp_dim, dropout)
        self.head_norm = _ln(dim)
        self.head = nn.Linear(dim, num_classes)

    def to_tokens(self, img: torch.Tensor) -> torch.Tensor:
        """The patch embedding without positions (mp3.py:166)."""
        x = patchify(img, self.patch)
        return self.patch_norm2(self.patch_embed(self.patch_norm1(x)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.to_tokens(img) + self.pos.to(img.dtype)
        return self.head(self.head_norm(self.transformer(x).mean(dim=1)))


class MP3(nn.Module):
    """mp3.py:150-186: every position-free token cross-attends to a random
    unmasked subset and classifies its own patch index;
    ``forward(img, generator)`` returns the loss.  The ViT's own head is
    not used (flax's MP3 tree has no ``vit/head*``; the port's holds the
    whole ViT)."""

    def __init__(self, vit: MP3ViT, masking_ratio: float):
        super().__init__()
        self.vit = vit
        self.masking_ratio = masking_ratio
        n = vit.pos.shape[0]
        self.mlp_head_norm = _ln(vit.dim)
        self.mlp_head_dense = nn.Linear(vit.dim, n)

    @staticmethod
    def permutation(b: int, n: int, generator: torch.Generator,
                    device) -> torch.Tensor:
        """One uniform random permutation of ``n`` per sample, ``(b, n)``."""
        return torch.rand(b, n, generator=generator,
                          device=device).argsort(dim=1)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        tokens = self.vit.to_tokens(img)
        b, n, _ = tokens.shape
        num_masked = int(self.masking_ratio * n)
        order = self.permutation(b, n, generator, img.device)
        rows = torch.arange(b, device=img.device)[:, None]
        unmasked = tokens[rows, order[:, num_masked:]]
        attended = self.vit.transformer(tokens, context=unmasked)
        logits = self.mlp_head_dense(self.mlp_head_norm(attended))
        logp = F.log_softmax(logits, dim=-1)
        return -logp.diagonal(dim1=1, dim2=2).mean()


# ---------------------------------------------------------------------------
# Distillation (distill.py)
# ---------------------------------------------------------------------------


class DistillableViT(nn.Module):
    """distill.py:17-62: a ViT that takes an extra distillation token
    after the position add; with one, returns ``(logits, distill_out)``."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        (h, w), (p1, p2) = _pair(image_size), _pair(patch_size)
        n = (h // p1) * (w // p2)
        self.dim, self.num_classes, self.pool = dim, num_classes, pool
        self.to_patch_embedding = _patch_embedding(
            p1 * p2 * channels, dim, Patches((p1, p2)))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.mlp_head = nn.Linear(dim, num_classes)

    def forward(self, img: torch.Tensor,
                distill_token: Optional[torch.Tensor] = None):
        x = _prepend(self.cls_token, self.to_patch_embedding(img))
        x = x + self.pos_embedding.to(x.dtype)
        if distill_token is not None:
            x = torch.cat([x, distill_token.to(x.dtype).expand(
                x.shape[0], 1, -1)], dim=1)
        x = self.transformer(self.dropout(x))
        if distill_token is not None:
            x, distill_out = x[:, :-1], x[:, -1]
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        logits = self.mlp_head(x)
        if distill_token is not None:
            return logits, distill_out
        return logits


def distill_loss(student_logits: torch.Tensor, distill_logits: torch.Tensor,
                 teacher_logits: torch.Tensor, labels: torch.Tensor,
                 temperature: float = 1.0, alpha: float = 0.5,
                 hard: bool = False) -> torch.Tensor:
    """distill.py:129-153: cross-entropy on the labels, plus soft KL
    (batch mean, times T^2) or hard cross-entropy against the teacher
    (no gradient to it), weighted 1 - alpha and alpha."""
    teacher_logits = teacher_logits.detach()
    ce = -F.log_softmax(student_logits, dim=-1).gather(
        -1, labels[:, None]).mean()
    if not hard:
        t = torch.softmax(teacher_logits / temperature, dim=-1)
        log_s = F.log_softmax(distill_logits / temperature, dim=-1)
        dl = (t * (torch.log(t + 1e-20) - log_s)).sum(dim=-1).mean()
        dl = dl * temperature ** 2
    else:
        hard_labels = teacher_logits.argmax(dim=-1)
        dl = -F.log_softmax(distill_logits, dim=-1).gather(
            -1, hard_labels[:, None]).mean()
    return ce * (1 - alpha) + dl * alpha


class DistillWrapper(nn.Module):
    """distill.py:100-153 with the teacher's logits as an input:
    ``forward(img, labels, teacher_logits)`` returns the loss."""

    def __init__(self, student: DistillableViT, temperature: float = 1.0,
                 alpha: float = 0.5, hard: bool = False):
        super().__init__()
        self.temperature, self.alpha, self.hard = temperature, alpha, hard
        self.distillation_token = nn.Parameter(torch.empty(1, 1,
                                                           student.dim))
        self.student = student
        self.distill_mlp_norm = _ln(student.dim)
        self.distill_mlp_dense = nn.Linear(student.dim, student.num_classes)

    def forward(self, img: torch.Tensor, labels: torch.Tensor,
                teacher_logits: torch.Tensor) -> torch.Tensor:
        student_logits, distill_tokens = self.student(
            img, distill_token=self.distillation_token)
        distill_logits = self.distill_mlp_dense(
            self.distill_mlp_norm(distill_tokens))
        return distill_loss(student_logits, distill_logits, teacher_logits,
                            labels, self.temperature, self.alpha, self.hard)


# ---------------------------------------------------------------------------
# Learnable-memory adapter (learnable_memory_vit.py)
# ---------------------------------------------------------------------------


class _MemAttention(nn.Module):
    """learnable_memory_vit.py:44-87: memories join the keys and values
    only; an optional boolean mask."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, attn_mask=None,
                memories=None) -> torch.Tensor:
        y = self.norm(x)
        kv = y
        if memories is not None:
            if memories.dim() == 2:
                memories = memories.expand(y.shape[0], -1, -1)
            kv = torch.cat([kv, memories.to(y.dtype)], dim=1)
        q = _heads(self.to_q(y), self.heads)
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(kv).chunk(2, dim=-1))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head ** -0.5
        if attn_mask is not None:
            dots = torch.where(attn_mask, dots, _NEG)
        attn = self.attn_drop(torch.softmax(dots, -1))
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.out_drop(self.to_out(_merge(out)))


class _MemTransformer(nn.Module):
    """learnable_memory_vit.py:89-105: per-layer memories."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", _MemAttention(dim, heads, dim_head,
                                                       dropout))
            self.add_module(f"ff_{i}", _FinalFeedForward(dim, mlp_dim,
                                                         dropout))

    def forward(self, x: torch.Tensor, attn_mask=None,
                memories=None) -> torch.Tensor:
        for i in range(self.depth):
            mem = None if memories is None else memories[i]
            x = getattr(self, f"attn_{i}")(x, attn_mask, mem) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


class MemoryViT(nn.Module):
    """learnable_memory_vit.py:107-153: the backbone ViT."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        (h, w), self.patch = _pair(image_size), _pair(patch_size)
        self.num_patches = (h // self.patch[0]) * (w // self.patch[1])
        self.dim, self.depth = dim, depth
        patch_dim = self.patch[0] * self.patch[1] * channels
        self.patch_norm1 = _ln(patch_dim)
        self.patch_embed = nn.Linear(patch_dim, dim)
        self.patch_norm2 = _ln(dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(
            torch.empty(1, self.num_patches + 1, dim))
        self.emb_drop = Dropout(emb_dropout)
        self.transformer = _MemTransformer(dim, depth, heads, dim_head,
                                           mlp_dim, dropout)
        self.head_norm = _ln(dim)
        self.head = nn.Linear(dim, num_classes)

    def img_to_tokens(self, img: torch.Tensor) -> torch.Tensor:
        x = patchify(img, self.patch)
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(x)))
        x = _prepend(self.cls_token, x) + self.pos_embedding.to(x.dtype)
        return self.emb_drop(x)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.transformer(self.img_to_tokens(img))
        return self.head(self.head_norm(x[:, 0]))


class MemoryAdapter(nn.Module):
    """learnable_memory_vit.py:157-218: a memory CLS query and per-layer
    memory key/value tokens over a backbone, under the reference's one-way
    mask (the main tokens see neither the memory CLS nor the memories, so
    the backbone's own tokens are unchanged).  The backbone's head is not
    used (flax's adapter tree has no ``vit/head*``)."""

    def __init__(self, vit: MemoryViT, num_memories_per_layer: int = 10,
                 num_classes: int = 2):
        super().__init__()
        n, m = vit.num_patches + 1, num_memories_per_layer
        mask = np.zeros((1 + n, 1 + n + m), dtype=bool)
        mask[1:, 1:1 + n] = True
        mask[0, :] = True
        self.register_buffer("attn_mask", torch.from_numpy(mask),
                             persistent=False)
        self.memory_cls_token = nn.Parameter(torch.empty(vit.dim))
        self.memories_per_layer = nn.Parameter(torch.empty(vit.depth, m,
                                                           vit.dim))
        self.vit = vit
        self.mlp_head_norm = _ln(vit.dim)
        self.mlp_head_dense = nn.Linear(vit.dim, num_classes)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        tokens = self.vit.img_to_tokens(img)
        mem_cls = self.memory_cls_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, -1)
        out = self.vit.transformer(torch.cat([mem_cls, tokens], dim=1),
                                   self.attn_mask, self.memories_per_layer)
        return self.mlp_head_dense(self.mlp_head_norm(out[:, 0]))


# ---------------------------------------------------------------------------
# EsViT (es_vit.py): view and region losses, projector
# ---------------------------------------------------------------------------


class EsViTProjector(nn.Module):
    """es_vit.py:118-140: a GELU MLP (every hidden layer GELU'd: the
    reference's ``is_last`` check never fires), L2 norm, the prototype
    projection.  ``dim`` is the input width."""

    def __init__(self, dim_out: int, num_layers: int = 4,
                 hidden_size: int = 256, *, dim: int):
        super().__init__()
        self.count = num_layers - 1
        for i in range(self.count):
            self.add_module(f"fc{i}", nn.Linear(dim if i == 0 else
                                                hidden_size, hidden_size))
        self.out = nn.Linear(hidden_size if self.count else dim, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.count):
            x = _gelu(getattr(self, f"fc{i}")(x))
        x = x / (x.norm(dim=-1, keepdim=True) + 1e-6)
        return self.out(x)


def esvit_view_loss(teacher_logits: torch.Tensor,
                    student_logits: torch.Tensor, centers: torch.Tensor,
                    teacher_temp: float = 0.04, student_temp: float = 0.9,
                    eps: float = 1e-20) -> torch.Tensor:
    """es_vit.py:48-59 (no gradient to the teacher)."""
    s = torch.softmax(student_logits / student_temp, dim=-1)
    t = torch.softmax((teacher_logits.detach() - centers) / teacher_temp,
                      dim=-1)
    return -(t * torch.log(s + eps)).sum(dim=-1).mean()


def esvit_region_loss(teacher_logits: torch.Tensor,
                      student_logits: torch.Tensor,
                      teacher_latent: torch.Tensor,
                      student_latent: torch.Tensor, centers: torch.Tensor,
                      teacher_temp: float = 0.04, student_temp: float = 0.9,
                      eps: float = 1e-20) -> torch.Tensor:
    """es_vit.py:61-80: each student region matched to the teacher region
    of largest dot-product similarity."""
    s = torch.softmax(student_logits / student_temp, dim=-1)
    t = torch.softmax((teacher_logits.detach() - centers) / teacher_temp,
                      dim=-1)
    sim = torch.einsum("bid,bjd->bij", student_latent, teacher_latent)
    idx = sim.argmax(dim=-1)                              # (b, n)
    matched = t.gather(1, idx[..., None].expand(-1, -1, t.shape[-1]))
    return -(matched * torch.log(s + eps)).sum(dim=-1).mean()


def esvit_center_update(center: torch.Tensor, batch_center: torch.Tensor,
                        momentum: float = 0.9) -> torch.Tensor:
    """es_vit.py:97-110: EMA centering."""
    return center * momentum + batch_center * (1.0 - momentum)


# ---------------------------------------------------------------------------
# MaxViT with registers (max_vit_with_registers.py)
# ---------------------------------------------------------------------------


def _register_bias_indices(w: int, r: int) -> np.ndarray:
    """max_vit_with_registers.py:147-159: the (r + w^2)^2 index table;
    every pair involving a register shares the table's extra last row."""
    n_bias = (2 * w - 1) ** 2
    return np.pad(_rel_bias_indices(w), ((r, 0), (r, 0)),
                  constant_values=n_bias).astype(np.int32)


class _RegisterWindowAttention(nn.Module):
    """max_vit_with_registers.py:116-198 on ``(B', r + w^2, d)`` tokens."""

    def __init__(self, dim: int, dim_head: int, window_size: int,
                 num_registers: int, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = dim // dim_head, dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2 + 1, self.heads))
        _index_buffer(self, "bias_idx",
                      _register_bias_indices(window_size, num_registers))
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        bias = self.rel_pos_bias[self.bias_idx].permute(2, 0, 1)
        out = _attend(q * self.dim_head ** -0.5, k, v, self.attn_drop, bias)
        return self.out_drop(self.to_out(_merge(out)))


class MaxViTWithRegisters(nn.Module):
    """max_vit_with_registers.py:200-340: MaxViT whose window attention
    carries per-block register tokens: they ride the block attention
    (and its feed-forward) in every window, are averaged over the windows,
    then ride the grid attention (not its feed-forward)."""

    def __init__(self, num_classes: int, dim: int, depth: Sequence[int],
                 dim_head: int = 32, dim_conv_stem: Optional[int] = None,
                 window_size: int = 7, mbconv_expansion_rate: float = 4.0,
                 mbconv_shrinkage_rate: float = 0.25, dropout: float = 0.1,
                 num_register_tokens: int = 4, *, channels: int = 3):
        super().__init__()
        if num_register_tokens <= 0:
            raise ValueError("num_register_tokens must be positive")
        stem = dim_conv_stem or dim
        self.window, self.registers = window_size, num_register_tokens
        self.stem1 = ConvCL(channels, stem, 3, 2, 1)
        self.stem2 = ConvCL(stem, stem, 3, 1, 1)
        self.blocks = []
        cin = stem
        for s, d in enumerate(depth):
            width = dim * 2 ** s
            for blk in range(d):
                pre = f"s{s}_b{blk}"
                self.blocks.append(pre)
                self.add_module(f"{pre}_mbconv", _MBConv(
                    cin, width, blk == 0, mbconv_expansion_rate,
                    mbconv_shrinkage_rate))
                self.register_parameter(f"{pre}_registers", nn.Parameter(
                    torch.empty(num_register_tokens, width)))
                for kind in ("block", "grid"):
                    self.add_module(f"{pre}_{kind}_attn",
                                    _RegisterWindowAttention(
                                        width, dim_head, window_size,
                                        num_register_tokens, dropout))
                    self.add_module(f"{pre}_{kind}_ff",
                                    _TokenFeedForward(width, dropout=dropout))
                cin = width
        self.head_norm = _ln(cin)
        self.head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        w, r = self.window, self.registers
        x = self.stem2(self.stem1(img))
        for pre in self.blocks:
            layer = (lambda name: getattr(self, f"{pre}_{name}"))
            x = layer("mbconv")(x)
            b, nx, ny, d = x.shape[0], x.shape[1] // w, x.shape[2] // w, \
                x.shape[3]
            t = _windows(x, w, w)
            rt = layer("registers").to(t.dtype).expand(t.shape[0], r, d)
            t = torch.cat([rt, t], dim=1)
            t = t + layer("block_attn")(t)
            t = t + layer("block_ff")(t)
            rt, t = t[:, :r], t[:, r:]
            x = _unwindows(t, b, nx, ny, w, w)
            rt = rt.reshape(b, nx * ny, r, d).mean(dim=1)
            t = _grid(x, w, w)
            rt = rt[:, None].expand(b, nx * ny, r, d).reshape(-1, r, d)
            t = torch.cat([rt, t], dim=1)
            t = (t + layer("grid_attn")(t))[:, r:]
            t = t + layer("grid_ff")(t)
            x = _ungrid(t, b, nx, ny, w, w)
        return self.head_norm(x.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# Extractor / Recorder (extractor.py / recorder.py) over forward hooks
# ---------------------------------------------------------------------------


def _path_sort_key(path: Sequence[str]):
    """The names of a module path in natural order (``layers.10`` after
    ``layers.9``), as JAX orders the sown maps."""
    key = []
    for part in path:
        for piece in re.split(r"(\d+)", part):
            if piece.isdigit():
                key.append((1, int(piece), ""))
            elif piece:
                key.append((0, 0, piece))
    return key


def extract(model: nn.Module, *args, layer_name: str = "transformer",
            **kwargs):
    """extractor.py:18-90 as a function: ``(model(*args, **kwargs),
    latent)``, the latent being the output of the first submodule named
    ``layer_name`` (by a forward hook, removed after the call)."""
    target = next((mod for name, mod in model.named_modules()
                   if name.rsplit(".", 1)[-1] == layer_name), None)
    if target is None:
        raise ValueError(f"layer {layer_name!r} not found")
    latents = []
    handle = target.register_forward_hook(
        lambda mod, inputs, output: latents.append(output))
    try:
        out = model(*args, **kwargs)
    finally:
        handle.remove()
    if not latents:
        raise ValueError(f"layer {layer_name!r} did not run")
    return out, latents[0]


def record_attention(model: nn.Module, *args, **kwargs):
    """recorder.py:10-59 as a function: ``(model(*args, **kwargs),
    attns)``, ``attns`` ``(B, layers, heads, N, N)`` stacking the
    post-softmax maps of every ``models/vit.py::Attention`` (the first
    call of each, in JAX's order of their paths), or None where the model
    has none.  The hooks only read: the output is the one without them,
    bit for bit."""
    maps = {}

    def keep(name):
        def hook(mod, inputs, output):
            maps.setdefault(name, output)
        return hook

    handles = [mod.attend.register_forward_hook(keep(name))
               for name, mod in model.named_modules()
               if isinstance(mod, Attention)]
    try:
        out = model(*args, **kwargs)
    finally:
        for handle in handles:
            handle.remove()
    if not maps:
        return out, None
    order = sorted(maps, key=lambda name: _path_sort_key(name.split(".")))
    return out, torch.stack([maps[name] for name in order], dim=1)
