"""ViT zoo, round 3 (counterpart of ``gfe_mamba_tpu/models/vit_zoo_hier.py``):
the hierarchical and windowed-attention members, LeViT, MaxViT, TwinsSVT,
XCiT, CrossFormer, RegionViT, ScalableViT and SepViT.

Channels-last feature maps ``(B, H, W, C)`` as in JAX, Linear layers
where the reference has 1x1 convs, convolutions on channels-first copies
inside (``vit_zoo_extra.ConvCL``).  The JAX classes' fields and
defaults; what flax infers from the input is keyword-only after them:
``channels`` everywhere, and SepViT's ``image_size`` (whether a stage
has more than one window decides whether its window-token attention has
weights).  Submodules keep the flax names (``s0_attn0``, ``s1_b0_mbconv``,
...), so a state_dict is the flax tree with torch layouts
(``utils/convert_zoo.py``).

The position-bias index tables are this module's own numpy copies of
JAX's, held as non-persistent buffers: a state_dict holds the learned
tables only, as flax's parameters do.  BatchNorms are flax's
(``ops/blocks.py::BatchNorm``); in train mode they normalize by the
batch statistics and move the running ones.  MaxViT's dropsample is a
``DropPath`` (one keep draw per sample from the generator
``seed_dropout`` attaches).  As in JAX, RegionViT's
``tokenize_local_3_conv`` stem (a LayerNorm over NCHW maps' width axis,
regionvit.py:213-221) is left out.

``init_zoo`` gives XCiT's LayerScale and temperature JAX's initial
values (``reset_extra``); LeViT's output BatchNorm scales keep the unit
init of every norm (the reference zero-inits them, which would leave the
attention branches out of any check of random weights).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit_zoo import _pair, patchify
from gfe_mamba_torch.models.vit_zoo_extra import (ConvCL, DropPath, _gelu,
                                                  _ln)
from gfe_mamba_torch.ops.blocks import BatchNorm


def _tuple_of(val, n: int) -> tuple:
    if isinstance(val, (tuple, list)):
        t = tuple(val)
        return t + (t[-1],) * (n - len(t))
    return (val,) * n


def _index_buffer(module: nn.Module, name: str, table: np.ndarray) -> None:
    module.register_buffer(name, torch.from_numpy(table.astype(np.int64)),
                           persistent=False)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """``b n (h d) -> b h n d``."""
    b, n, _ = t.shape
    return t.reshape(b, n, h, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """``b h n d -> b n (h d)``."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """``b x y d -> b (x y) d``."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _attend(q, k, v, drop=None, bias=None, scale=None) -> torch.Tensor:
    """softmax(q k^T [* scale] [+ bias]) v over ``(b, h, n, d)`` heads,
    the softmax through ``drop``; each model scales q or the logits where
    its JAX module does."""
    sim = torch.einsum("bhid,bhjd->bhij", q, k)
    if scale is not None:
        sim = sim * scale
    if bias is not None:
        sim = sim + bias
    attn = torch.softmax(sim, -1)
    return torch.einsum("bhij,bhjd->bhid",
                        attn if drop is None else drop(attn), v)


def _windows(x: torch.Tensor, w1: int, w2: int) -> torch.Tensor:
    """``b (x w1) (y w2) d -> (b x y) (w1 w2) d``."""
    b, hh, ww, d = x.shape
    return x.reshape(b, hh // w1, w1, ww // w2, w2, d) \
        .permute(0, 1, 3, 2, 4, 5).reshape(-1, w1 * w2, d)


def _unwindows(t: torch.Tensor, b: int, nx: int, ny: int, w1: int,
               w2: int) -> torch.Tensor:
    """``(b x y) (w1 w2) d -> b (x w1) (y w2) d``."""
    d = t.shape[-1]
    return t.reshape(b, nx, ny, w1, w2, d).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, nx * w1, ny * w2, d)


def _grid(x: torch.Tensor, w1: int, w2: int) -> torch.Tensor:
    """``b (w1 x) (w2 y) d -> (b x y) (w1 w2) d`` (the dilated grid)."""
    b, hh, ww, d = x.shape
    return x.reshape(b, w1, hh // w1, w2, ww // w2, d) \
        .permute(0, 2, 4, 1, 3, 5).reshape(-1, w1 * w2, d)


def _ungrid(t: torch.Tensor, b: int, nx: int, ny: int, w1: int,
            w2: int) -> torch.Tensor:
    """``(b x y) (w1 w2) d -> b (w1 x) (w2 y) d``."""
    d = t.shape[-1]
    return t.reshape(b, nx, ny, w1, w2, d).permute(0, 3, 1, 4, 2, 5) \
        .reshape(b, w1 * nx, w2 * ny, d)


def _space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """``b (h p1) (w p2) c -> b h w (c p1 p2)``."""
    b, hh, ww, c = x.shape
    return x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 2, 4) \
        .reshape(b, hh // p, ww // p, c * p * p)


def _rel_bias_indices(w: int) -> np.ndarray:
    """(w^2, w^2) indices into a (2w-1)^2 relative-position table
    (max_vit.py:152-158)."""
    pos = np.arange(w)
    gy, gx = np.meshgrid(pos, pos, indexing="ij")
    grid = np.stack([gy, gx], -1).reshape(-1, 2)
    rel = grid[:, None] - grid[None, :] + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


# ---------------------------------------------------------------------------
# LeViT (levit.py)
# ---------------------------------------------------------------------------


def _levit_pos_indices(fmap: int, downsample: bool) -> np.ndarray:
    """Absolute |d| position-bias indices (levit.py:71-83): |dx| * fmap +
    |dy| into a (fmap^2,) table."""
    q_range = np.arange(0, fmap, 2 if downsample else 1)
    k_range = np.arange(fmap)
    qy, qx = np.meshgrid(q_range, q_range, indexing="ij")
    ky, kx = np.meshgrid(k_range, k_range, indexing="ij")
    q_pos = np.stack([qy, qx], -1).reshape(-1, 2)
    k_pos = np.stack([ky, kx], -1).reshape(-1, 2)
    rel = np.abs(q_pos[:, None] - k_pos[None, :])
    return (rel[..., 0] * fmap + rel[..., 1]).astype(np.int32)


class _LeViTAttention(nn.Module):
    """levit.py:40-108: BatchNorm'd projections, the learned
    absolute-distance bias added as ``bias / scale``, GELU -> Linear ->
    BatchNorm out."""

    def __init__(self, dim_in: int, fmap_size: int, heads: int,
                 dim_key: int, dim_value: int, dim_out: int,
                 downsample: bool = False, dropout: float = 0.0):
        super().__init__()
        self.heads, self.scale = heads, dim_key ** -0.5
        self.stride = 2 if downsample else 1
        self.to_q = nn.Linear(dim_in, dim_key * heads, bias=False)
        self.q_bn = BatchNorm(dim_key * heads)
        self.to_k = nn.Linear(dim_in, dim_key * heads, bias=False)
        self.k_bn = BatchNorm(dim_key * heads)
        self.to_v = nn.Linear(dim_in, dim_value * heads, bias=False)
        self.v_bn = BatchNorm(dim_value * heads)
        self.pos_bias = nn.Parameter(torch.empty(fmap_size ** 2, heads))
        _index_buffer(self, "pos_idx",
                      _levit_pos_indices(fmap_size, downsample))
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(dim_value * heads, dim_out)
        self.out_bn = BatchNorm(dim_out)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, h = self.stride, self.heads
        q = self.q_bn(self.to_q(x[:, ::s, ::s]))
        b, qx, qy, _ = q.shape
        k = self.k_bn(self.to_k(x))
        v = self.v_bn(self.to_v(x))
        bias = self.pos_bias[self.pos_idx].permute(2, 0, 1) / self.scale
        out = _attend(_heads(_tokens(q), h), _heads(_tokens(k), h),
                      _heads(_tokens(v), h), self.attn_drop, bias,
                      self.scale)
        out = self.to_out(_gelu(_merge(out).reshape(b, qx, qy, -1)))
        return self.out_drop(self.out_bn(out))


class _LeViTFeedForward(nn.Module):
    """levit.py:27-38: Linear -> hardswish -> Linear."""

    def __init__(self, dim: int, mult: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * mult)
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(dim * mult, dim)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(F.hardswish(self.fc1(x)))))


class LeViT(nn.Module):
    """levit.py:129-195: a 4-conv stride-16 stem, stages of attention +
    feed-forward joined by downsampling attention (stride-2 queries,
    doubled heads, no attention residual), mean pool, one head (two with
    ``num_distill_classes``)."""

    def __init__(self, image_size: int, num_classes: int, dim, depth, heads,
                 mlp_mult: int = 2, stages: int = 3, dim_key: int = 32,
                 dim_value: int = 64, dropout: float = 0.0,
                 num_distill_classes: Optional[int] = None, *,
                 channels: int = 3):
        super().__init__()
        dims = _tuple_of(dim, stages)
        self.depths = _tuple_of(depth, stages)
        heads = _tuple_of(heads, stages)
        cin = channels
        for i, ch in enumerate((32, 64, 128, dims[0])):
            self.add_module(f"stem_{i}", ConvCL(cin, ch, 3, 2, 1))
            cin = ch
        fmap = image_size // 16
        for s in range(stages):
            for d in range(self.depths[s]):
                self.add_module(f"s{s}_attn{d}", _LeViTAttention(
                    dims[s], fmap, heads[s], dim_key, dim_value, dims[s],
                    dropout=dropout))
                self.add_module(f"s{s}_ff{d}", _LeViTFeedForward(
                    dims[s], mlp_mult, dropout))
            if s < stages - 1:
                self.add_module(f"s{s}_down_attn", _LeViTAttention(
                    dims[s], fmap, heads[s] * 2, dim_key, dim_value,
                    dims[s + 1], downsample=True, dropout=dropout))
                fmap = math.ceil(fmap / 2)
                self.add_module(f"s{s}_down_ff", _LeViTFeedForward(
                    dims[s + 1], mlp_mult, dropout))
        self.mlp_head = nn.Linear(dims[-1], num_classes)
        self.distill_head = None if num_distill_classes is None else \
            nn.Linear(dims[-1], num_distill_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for i in range(4):
            x = getattr(self, f"stem_{i}")(x)
        for s, depth in enumerate(self.depths):
            for d in range(depth):
                x = x + getattr(self, f"s{s}_attn{d}")(x)
                x = x + getattr(self, f"s{s}_ff{d}")(x)
            if s < len(self.depths) - 1:
                x = getattr(self, f"s{s}_down_attn")(x)
                x = x + getattr(self, f"s{s}_down_ff")(x)
        return x.mean(dim=(1, 2))

    def forward(self, img: torch.Tensor):
        pooled = self.features(img)
        out = self.mlp_head(pooled)
        if self.distill_head is not None:
            return out, self.distill_head(pooled)
        return out


# ---------------------------------------------------------------------------
# MaxViT (max_vit.py)
# ---------------------------------------------------------------------------


class _SqueezeExcite2D(nn.Module):
    """max_vit.py:47-62."""

    def __init__(self, dim: int, shrinkage_rate: float = 0.25):
        super().__init__()
        hidden = int(dim * shrinkage_rate)
        self.fc1 = nn.Linear(dim, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.fc2(F.silu(self.fc1(x.mean(dim=(1, 2)))))
        return x * torch.sigmoid(g)[:, None, None, :]


class _MBConv(nn.Module):
    """max_vit.py:90-117: expand + BN + GELU, depthwise 3x3 (stride 2 on
    downsample) + BN + GELU, squeeze-excite, project + BN; the residual,
    through a per-sample dropsample, where the shapes match."""

    def __init__(self, dim_in: int, dim_out: int, downsample: bool,
                 expansion_rate: float = 4.0, shrinkage_rate: float = 0.25,
                 dropout: float = 0.0):
        super().__init__()
        hidden = int(expansion_rate * dim_out)
        self.expand = nn.Linear(dim_in, hidden)
        self.bn1 = BatchNorm(hidden)
        self.dw = ConvCL(hidden, hidden, 3, 2 if downsample else 1, 1,
                         groups=hidden)
        self.bn2 = BatchNorm(hidden)
        self.se = _SqueezeExcite2D(hidden, shrinkage_rate)
        self.project = nn.Linear(hidden, dim_out)
        self.bn3 = BatchNorm(dim_out)
        self.residual = dim_in == dim_out and not downsample
        self.dropsample = DropPath(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _gelu(self.bn1(self.expand(x)))
        y = self.se(_gelu(self.bn2(self.dw(y))))
        y = self.bn3(self.project(y))
        return self.dropsample(y) + x if self.residual else y


class _WindowAttention(nn.Module):
    """max_vit.py:121-206 on windowed tokens ``(B', w^2, d)`` with a
    (2w-1)^2 learned relative-position-bias table."""

    def __init__(self, dim: int, dim_head: int, window_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = dim // dim_head, dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, self.heads))
        _index_buffer(self, "bias_idx", _rel_bias_indices(window_size))
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        bias = self.rel_pos_bias[self.bias_idx].permute(2, 0, 1)
        out = _attend(q * self.dim_head ** -0.5, k, v, self.attn_drop, bias)
        return self.out_drop(self.to_out(_merge(out)))


class _TokenFeedForward(nn.Module):
    """max_vit.py:30-43: LN -> Linear (dim * mult) -> GELU -> Linear."""

    def __init__(self, dim: int, mult: float = 4.0, dropout: float = 0.0):
        super().__init__()
        hidden = int(dim * mult)
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop1(_gelu(self.fc1(self.norm(x))))
        return self.drop2(self.fc2(y))


class MaxViT(nn.Module):
    """max_vit.py:208-291: a 2-conv stem, then per block an MBConv,
    block-local window attention + feed-forward, grid-dilated window
    attention + feed-forward; LayerNorm'd mean pool, head."""

    def __init__(self, num_classes: int, dim: int, depth: Sequence[int],
                 dim_head: int = 32, dim_conv_stem: Optional[int] = None,
                 window_size: int = 7, mbconv_expansion_rate: float = 4.0,
                 mbconv_shrinkage_rate: float = 0.25, dropout: float = 0.1,
                 *, channels: int = 3):
        super().__init__()
        stem = dim_conv_stem or dim
        self.window = window_size
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
                for kind in ("block", "grid"):
                    self.add_module(f"{pre}_{kind}_attn", _WindowAttention(
                        width, dim_head, window_size, dropout))
                    self.add_module(f"{pre}_{kind}_ff",
                                    _TokenFeedForward(width, dropout=dropout))
                cin = width
        self.head_norm = _ln(cin)
        self.head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        w = self.window
        x = self.stem2(self.stem1(img))
        for pre in self.blocks:
            layer = (lambda name: getattr(self, f"{pre}_{name}"))
            x = layer("mbconv")(x)
            b, nx, ny = x.shape[0], x.shape[1] // w, x.shape[2] // w
            t = _windows(x, w, w)
            t = t + layer("block_attn")(t)
            t = t + layer("block_ff")(t)
            t = _grid(_unwindows(t, b, nx, ny, w, w), w, w)
            t = t + layer("grid_attn")(t)
            t = t + layer("grid_ff")(t)
            x = _ungrid(t, b, nx, ny, w, w)
        return self.head_norm(x.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# Twins-SVT (twins_svt.py)
# ---------------------------------------------------------------------------


class _ConvFeedForward(nn.Module):
    """twins_svt.py:45-57 (1x1 convs as Linear layers)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, dim * mult)
        self.drop1 = Dropout(dropout)
        self.fc2 = nn.Linear(dim * mult, dim)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.drop1(_gelu(self.fc1(self.norm(x))))
        return self.drop2(self.fc2(y))


class _TwinsLocalAttention(nn.Module):
    """twins_svt.py:85-120: attention within each patch_size window."""

    def __init__(self, dim: int, heads: int, dim_head: int, patch_size: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.patch = heads, dim_head, patch_size
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, h = self.patch, self.heads
        b, nx, ny = x.shape[0], x.shape[1] // p, x.shape[2] // p
        win = _windows(self.norm(x), p, p)
        q = _heads(self.to_q(win), h) * self.dim_head ** -0.5
        k, v = (_heads(t, h) for t in self.to_kv(win).chunk(2, dim=-1))
        out = _attend(q, k, v)
        out = _unwindows(_merge(out), b, nx, ny, p, p)
        return self.out_drop(self.to_out(out))


class _TwinsGlobalAttention(nn.Module):
    """twins_svt.py:122-157: every query over keys and values from a
    k-strided conv."""

    def __init__(self, dim: int, heads: int, dim_head: int, k: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = ConvCL(dim, inner * 2, k, k, 0, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.heads
        y = self.norm(x)
        q = _heads(_tokens(self.to_q(y)), h) * self.dim_head ** -0.5
        k, v = (_heads(_tokens(t), h)
                for t in self.to_kv(y).chunk(2, dim=-1))
        out = _merge(_attend(q, k, v, self.attn_drop)).reshape(
            *x.shape[:3], -1)
        return self.out_drop(self.to_out(out))


class _PEG(nn.Module):
    """Position encoding generator: a residual depthwise conv
    (twins_svt.py:77-83)."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.proj = ConvCL(dim, dim, kernel_size, 1, kernel_size // 2,
                           groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(x)


class _TwinsBlock(nn.Module):
    """``depth`` layers of [local + ff,] global + ff
    (twins_svt.py:159-176)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_mult: int, local_patch_size: int, global_k: int,
                 dropout: float, has_local: bool):
        super().__init__()
        self.depth, self.has_local = depth, has_local
        for i in range(depth):
            if has_local:
                self.add_module(f"l{i}_local", _TwinsLocalAttention(
                    dim, heads, dim_head, local_patch_size, dropout))
                self.add_module(f"l{i}_ff1", _ConvFeedForward(
                    dim, mlp_mult, dropout))
            self.add_module(f"l{i}_global", _TwinsGlobalAttention(
                dim, heads, dim_head, global_k, dropout))
            self.add_module(f"l{i}_ff2", _ConvFeedForward(dim, mlp_mult,
                                                          dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        names = ("local", "ff1", "global", "ff2") if self.has_local \
            else ("global", "ff2")
        for i in range(self.depth):
            for name in names:
                x = x + getattr(self, f"l{i}_{name}")(x)
        return x


class TwinsSVT(nn.Module):
    """twins_svt.py:178-235: four stages of space-to-depth patch merging
    (LN -> Linear -> LN), one layer group, a PEG, the stage's layer
    groups (the last stage global attention only); mean pool, head."""

    def __init__(self, num_classes: int,
                 embed_dims: Sequence[int] = (64, 128, 256, 512),
                 patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 local_patch_sizes: Sequence[int] = (7, 7, 7, 7),
                 global_ks: Sequence[int] = (7, 7, 7, 7),
                 depths: Sequence[int] = (1, 1, 5, 4),
                 peg_kernel_size: int = 3, heads: int = 8,
                 dim_head: int = 64, mlp_mult: int = 4,
                 dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        self.patch_sizes = tuple(patch_sizes)
        cin = channels
        n = len(embed_dims)
        for s, dim in enumerate(embed_dims):
            p = patch_sizes[s]
            block = (lambda depth: _TwinsBlock(
                dim, depth, heads, dim_head, mlp_mult, local_patch_sizes[s],
                global_ks[s], dropout, s < n - 1))
            self.add_module(f"s{s}_pe_norm1", _ln(cin * p * p))
            self.add_module(f"s{s}_pe_proj", nn.Linear(cin * p * p, dim))
            self.add_module(f"s{s}_pe_norm2", _ln(dim))
            self.add_module(f"s{s}_pre", block(1))
            self.add_module(f"s{s}_peg", _PEG(dim, peg_kernel_size))
            self.add_module(f"s{s}_main", block(depths[s]))
            cin = dim
        self.head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for s, p in enumerate(self.patch_sizes):
            layer = (lambda name: getattr(self, f"s{s}_{name}"))
            x = _space_to_depth(x, p)
            x = layer("pe_norm2")(layer("pe_proj")(layer("pe_norm1")(x)))
            x = layer("main")(layer("peg")(layer("pre")(x)))
        return x.mean(dim=(1, 2))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# XCiT (xcit.py)
# ---------------------------------------------------------------------------


def _layer_scale_init(layer: int) -> float:
    """xcit.py:42-50 as it behaves: 0.1 for layer <= 18, else 1e-6 (the
    reference's chained comparison for 1e-5 is never true)."""
    return 0.1 if layer <= 18 else 1e-6


class _LayerScaled(nn.Module):
    """A sub-module's output times a learned per-channel ``gamma`` (flax's
    ``scale``)."""

    def __init__(self, dim: int, init_eps: float):
        super().__init__()
        self.init_eps = init_eps
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_extra(self, generator: torch.Generator) -> None:
        self.gamma.fill_(self.init_eps)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.gamma


class _XCAttention(nn.Module):
    """xcit.py:109-148: d x d cross-covariance attention, q and k
    L2-normalised over the tokens, a learned per-head log-temperature."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.temperature = nn.Parameter(torch.empty(heads, 1, 1))
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def reset_extra(self, generator: torch.Generator) -> None:
        self.temperature.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads).transpose(-1, -2)    # b h d n
                   for t in self.to_qkv(self.norm(_tokens(x))).chunk(3, -1))
        q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        sim = torch.einsum("bhin,bhjn->bhij", q, k) * self.temperature.exp()
        out = torch.einsum("bhij,bhjn->bhin",
                           self.attn_drop(torch.softmax(sim, -1)), v)
        out = self.out_drop(self.to_out(_merge(out.transpose(-1, -2))))
        return out.reshape(x.shape)


class _LocalPatchInteraction(nn.Module):
    """xcit.py:150-167: LN -> depthwise conv -> BN -> GELU -> depthwise
    conv."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.norm = _ln(dim)
        self.conv1 = ConvCL(dim, dim, kernel_size, 1, pad, groups=dim)
        self.bn = BatchNorm(dim)
        self.conv2 = ConvCL(dim, dim, kernel_size, 1, pad, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(_gelu(self.bn(self.conv1(self.norm(x)))))


class _ContextAttention(nn.Module):
    """xcit.py:72-107: attention with keys and values over [normed x,
    context]."""

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

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.norm(x)
        ctx = y if context is None else torch.cat([y, context], dim=1)
        q = _heads(self.to_q(y), self.heads)
        k, v = (_heads(t, self.heads)
                for t in self.to_kv(ctx).chunk(2, dim=-1))
        return self.out_drop(self.to_out(_merge(_attend(
            q, k, v, self.attn_drop, scale=self.dim_head ** -0.5))))


class XCiT(nn.Module):
    """xcit.py:215-283: patch embedding + learned positions, layers of
    [XCA, local patch interaction, feed-forward] each LayerScaled, then
    class-attention layers in which only the CLS token queries [CLS,
    patch tokens]; LayerNorm, head.  ``image_size`` may be a pair (the
    position table's grid).  ``layer_dropout`` is not reproduced, as in
    JAX (the reference's default is 0)."""

    def __init__(self, image_size, patch_size: int, num_classes: int,
                 dim: int, depth: int, cls_depth: int, heads: int,
                 mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, local_patch_kernel_size: int = 3,
                 *, channels: int = 3):
        super().__init__()
        p = patch_size
        h, w = _pair(image_size)
        self.patch, self.grid = p, (h // p, w // p)
        self.depth, self.cls_depth = depth, cls_depth
        mult = mlp_dim / dim
        self.patch_norm1 = _ln(p * p * channels)
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.patch_norm2 = _ln(dim)
        self.pos_embedding = nn.Parameter(
            torch.empty(1, self.grid[0] * self.grid[1], dim))
        self.emb_drop = Dropout(emb_dropout)
        for i in range(depth):
            eps = _layer_scale_init(i + 1)
            self.add_module(f"l{i}_xca", _XCAttention(dim, heads, dim_head,
                                                      dropout))
            self.add_module(f"l{i}_lpi", _LocalPatchInteraction(
                dim, local_patch_kernel_size))
            self.add_module(f"l{i}_ff", _TokenFeedForward(dim, mult,
                                                          dropout))
            for name in ("xca", "lpi", "ff"):
                self.add_module(f"l{i}_{name}_scale", _LayerScaled(dim, eps))
        self.final_norm = _ln(dim)
        self.cls_token = nn.Parameter(torch.empty(dim))
        for i in range(cls_depth):
            eps = _layer_scale_init(i + 1)
            self.add_module(f"cls{i}_attn", _ContextAttention(
                dim, heads, dim_head, dropout))
            self.add_module(f"cls{i}_ff", _TokenFeedForward(dim, mult,
                                                            dropout))
            for name in ("attn", "ff"):
                self.add_module(f"cls{i}_{name}_scale",
                                _LayerScaled(dim, eps))
        self.head_norm = _ln(dim)
        self.head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        b, (gh, gw) = img.shape[0], self.grid
        x = patchify(img, (self.patch,) * 2).reshape(b, gh, gw, -1)
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(x)))
        x = self.emb_drop(x + self.pos_embedding.reshape(1, gh, gw, -1))
        for i in range(self.depth):
            for name in ("xca", "lpi", "ff"):
                y = getattr(self, f"l{i}_{name}")(x)
                x = x + getattr(self, f"l{i}_{name}_scale")(y)
        tokens = _tokens(self.final_norm(x))
        cls = self.cls_token.expand(b, 1, -1)
        for i in range(self.cls_depth):
            y = getattr(self, f"cls{i}_attn")(cls, tokens)
            cls = cls + getattr(self, f"cls{i}_attn_scale")(y)
            y = getattr(self, f"cls{i}_ff")(cls)
            cls = cls + getattr(self, f"cls{i}_ff_scale")(y)
        return self.head_norm(cls[:, 0])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# CrossFormer (crossformer.py)
# ---------------------------------------------------------------------------


class _CrossEmbed(nn.Module):
    """crossformer.py:14-36: parallel strided convs of several kernel
    sizes (ascending), output channels split geometrically, concatenated."""

    def __init__(self, dim_in: int, dim_out: int,
                 kernel_sizes: Sequence[int], stride: int = 2):
        super().__init__()
        kernels = sorted(kernel_sizes)
        scales = [dim_out // 2 ** i for i in range(1, len(kernels))]
        scales = [*scales, dim_out - sum(scales)]
        self.count = len(kernels)
        for i, (k, d) in enumerate(zip(kernels, scales)):
            self.add_module(f"conv{i}", ConvCL(dim_in, d, k, stride,
                                               (k - stride) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"conv{i}")(x)
                          for i in range(self.count)], dim=-1)


class _DynamicPositionBias(nn.Module):
    """crossformer.py:40-53: an MLP from a 2D offset to a scalar bias."""

    def __init__(self, dim: int):
        super().__init__()
        for i in range(3):
            self.add_module(f"fc{i}", nn.Linear(2 if i == 0 else dim, dim))
            self.add_module(f"norm{i}", _ln(dim))
        self.out = nn.Linear(dim, 1)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        y = coords
        for i in range(3):
            y = F.relu(getattr(self, f"norm{i}")(getattr(self, f"fc{i}")(y)))
        return self.out(y)[..., 0]


def _crossformer_bias_tables(w: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's coordinate table and index math
    (crossformer.py:110-117,146-150): coordinates over (-w..w) with row
    stride 2w+1, indices with stride 2w-1, an injective (if scrambled)
    assignment that is part of the trained function."""
    pos = np.arange(-w, w + 1)
    gy, gx = np.meshgrid(pos, pos, indexing="ij")
    coords = np.stack([gy, gx], -1).reshape(-1, 2).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"),
                    0).reshape(2, -1)
    rel = grid[:, :, None] - grid[:, None, :] + (w - 1)
    idx = (rel * np.array([2 * w - 1, 1])[:, None, None]).sum(0)
    return coords, idx.astype(np.int32)


class _CrossFormerAttention(nn.Module):
    """crossformer.py:78-172: short-distance (window) or long-distance
    (dilated grid) attention with the dynamic position bias."""

    def __init__(self, dim: int, attn_type: str, window_size: int,
                 dim_head: int = 32, dropout: float = 0.0):
        super().__init__()
        if attn_type not in ("short", "long"):
            raise ValueError(f"attn_type must be 'short' or 'long', got "
                             f"{attn_type!r}")
        self.heads = dim // dim_head
        self.dim_head, self.long = dim_head, attn_type == "long"
        self.window = window_size
        inner = self.heads * dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.dpb = _DynamicPositionBias(dim // 4)
        coords, idx = _crossformer_bias_tables(window_size)
        self.register_buffer("coords", torch.from_numpy(coords),
                             persistent=False)
        _index_buffer(self, "bias_idx", idx)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.window
        b, nx, ny = x.shape[0], x.shape[1] // w, x.shape[2] // w
        part, unpart = (_grid, _ungrid) if self.long \
            else (_windows, _unwindows)
        q, k, v = (_heads(t, self.heads) for t in
                   self.to_qkv(part(self.norm(x), w, w)).chunk(3, dim=-1))
        bias = self.dpb(self.coords.to(x.dtype))[self.bias_idx]
        out = _attend(q * self.dim_head ** -0.5, k, v, self.attn_drop, bias)
        return unpart(self.to_out(_merge(out)), b, nx, ny, w, w)


class _CrossFormerFF(nn.Module):
    """crossformer.py:69-76 (no dropout after the second layer)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.norm = _ln(dim)
        self.fc1 = nn.Linear(dim, dim * mult)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.drop(_gelu(self.fc1(self.norm(x)))))


class CrossFormer(nn.Module):
    """crossformer.py:208-267: four stages of cross-scale embedding, then
    layers of short attention, ff, long attention, ff; mean pool, head."""

    def __init__(self, num_classes: int,
                 dim: Sequence[int] = (64, 128, 256, 512),
                 depth: Sequence[int] = (2, 2, 8, 2),
                 global_window_size: Sequence[int] = (8, 4, 2, 1),
                 local_window_size=7,
                 cross_embed_kernel_sizes: Sequence[Sequence[int]] = (
                     (4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides: Sequence[int] = (4, 2, 2, 2),
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        local_ws = _tuple_of(local_window_size, 4)
        self.depth = tuple(depth)
        cin = channels
        for s in range(4):
            width = dim[s]
            self.add_module(f"s{s}_cel", _CrossEmbed(
                cin, width, cross_embed_kernel_sizes[s],
                cross_embed_strides[s]))
            for layer in range(depth[s]):
                pre = f"s{s}_l{layer}"
                self.add_module(f"{pre}_short", _CrossFormerAttention(
                    width, "short", local_ws[s], dropout=attn_dropout))
                self.add_module(f"{pre}_sff", _CrossFormerFF(
                    width, dropout=ff_dropout))
                self.add_module(f"{pre}_long", _CrossFormerAttention(
                    width, "long", global_window_size[s],
                    dropout=attn_dropout))
                self.add_module(f"{pre}_lff", _CrossFormerFF(
                    width, dropout=ff_dropout))
            cin = width
        self.head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for s, depth in enumerate(self.depth):
            x = getattr(self, f"s{s}_cel")(x)
            for layer in range(depth):
                for name in ("short", "sff", "long", "lff"):
                    x = x + getattr(self, f"s{s}_l{layer}_{name}")(x)
        return x.mean(dim=(1, 2))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# RegionViT (regionvit.py)
# ---------------------------------------------------------------------------


class _BiasAttention(nn.Module):
    """regionvit.py:50-100: pre-LN attention with an optional additive
    bias.  One instance serves both the regional self-attention and the
    joint region + local attention of a layer (regionvit.py:152-164)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, rel_pos_bias=None) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = _attend(q * self.dim_head ** -0.5, k, v, self.attn_drop,
                      rel_pos_bias)
        return self.out_drop(self.to_out(_merge(out)))


def _region_local_bias_indices(wh: int, ww: int, w: int) -> np.ndarray:
    """regionvit.py:136-148: window-local relative bias indices into a
    (2w-1)^2 table (w the configured window size)."""
    gy, gx = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    grid = np.stack([gy.reshape(-1), gx.reshape(-1)])
    rel = grid[:, :, None] - grid[:, None, :] + (w - 1)
    return (rel[0] + rel[1] * (2 * w - 1)).astype(np.int32)


class _R2LTransformer(nn.Module):
    """regionvit.py:102-178: per layer the regional tokens attend among
    themselves, then each local window with its region token in front
    (the same attention weights), then a feed-forward over both."""

    def __init__(self, dim: int, depth: int, window_size: int,
                 heads: int = 4, dim_head: int = 32,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0):
        super().__init__()
        self.depth, self.window = depth, window_size
        self.local_rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, heads))
        for i in range(depth):
            self.add_module(f"l{i}_attn", _BiasAttention(
                dim, heads, dim_head, attn_dropout))
            self.add_module(f"l{i}_ff", _TokenFeedForward(dim, 4,
                                                          ff_dropout))

    def forward(self, local: torch.Tensor, region: torch.Tensor):
        b, lh, lw, d = local.shape
        rh, rw = region.shape[1], region.shape[2]
        wh, ww = lh // rh, lw // rw
        # the windows' shape follows the input's, so the table is made here
        idx = torch.from_numpy(_region_local_bias_indices(
            wh, ww, self.window).astype(np.int64)).to(local.device)
        bias = F.pad(self.local_rel_pos_bias[idx].permute(2, 0, 1),
                     (1, 0, 1, 0))[None]
        region = region.reshape(b, rh * rw, d)
        for i in range(self.depth):
            attn = getattr(self, f"l{i}_attn")
            region = attn(region) + region
            joint = torch.cat([region.reshape(b * rh * rw, 1, d),
                               _windows(local, wh, ww)], dim=1)
            joint = attn(joint, bias) + joint
            joint = joint + getattr(self, f"l{i}_ff")(joint)
            local = _unwindows(joint[:, 1:], b, rh, rw, wh, ww)
            region = joint[:, 0].reshape(b, rh * rw, d)
        return local, region.reshape(b, rh, rw, d)


class RegionViT(nn.Module):
    """regionvit.py:182-269 with the default single-conv local
    tokenizer: a local stream (8x8 stride-4 conv) and a regional one
    (space-to-depth of local_patch_size * window_size patches, Linear),
    four stages of [a shared strided conv down both streams, optional
    PEG on the local one] + R2L layers; LayerNorm'd mean of the regional
    tokens, head."""

    def __init__(self, num_classes: int,
                 dim: Sequence[int] = (64, 128, 256, 512),
                 depth: Sequence[int] = (2, 2, 8, 2), window_size: int = 7,
                 local_patch_size: int = 4, use_peg: bool = False,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        self.region_patch = local_patch_size * window_size
        self.use_peg = use_peg
        rp = self.region_patch
        self.local_encoder = ConvCL(channels, dim[0], 8, 4, 3)
        self.region_encoder = nn.Linear(channels * rp * rp, dim[0])
        for s in range(4):
            if s > 0:
                # one conv serves both streams: the reference shares the
                # Downsample weights (regionvit.py:264-265)
                self.add_module(f"s{s}_down", ConvCL(dim[s - 1], dim[s], 3,
                                                     2, 1))
                if use_peg:
                    self.add_module(f"s{s}_peg", _PEG(dim[s]))
            self.add_module(f"s{s}_r2l", _R2LTransformer(
                dim[s], depth[s], window_size, attn_dropout=attn_dropout,
                ff_dropout=ff_dropout))
        self.head_norm = _ln(dim[3])
        self.head = nn.Linear(dim[3], num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        rp = self.region_patch
        if img.shape[1] % rp or img.shape[2] % rp:
            raise ValueError("image size must be divisible by "
                             "local_patch_size * window_size")
        local = self.local_encoder(img)
        region = self.region_encoder(_space_to_depth(img, rp))
        for s in range(4):
            if s > 0:
                down = getattr(self, f"s{s}_down")
                local, region = down(local), down(region)
                if self.use_peg:
                    local = getattr(self, f"s{s}_peg")(local)
            local, region = getattr(self, f"s{s}_r2l")(local, region)
        return self.head_norm(region.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# ScalableViT (scalable_vit.py)
# ---------------------------------------------------------------------------


class _ScalableSelfAttention(nn.Module):
    """scalable_vit.py:71-124: keys and values reduced by an r-strided
    conv."""

    def __init__(self, dim: int, heads: int, dim_key: int, dim_value: int,
                 reduction_factor: int, dropout: float = 0.0):
        super().__init__()
        r = reduction_factor
        self.heads, self.dim_key = heads, dim_key
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, dim_key * heads, bias=False)
        self.to_k = ConvCL(dim, dim_key * heads, r, r, 0, bias=False)
        self.to_v = ConvCL(dim, dim_value * heads, r, r, 0, bias=False)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(dim_value * heads, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.heads
        y = self.norm(x)
        q = _heads(_tokens(self.to_q(y)), h) * self.dim_key ** -0.5
        k = _heads(_tokens(self.to_k(y)), h)
        v = _heads(_tokens(self.to_v(y)), h)
        out = _merge(_attend(q, k, v, self.attn_drop)).reshape(
            *x.shape[:3], -1)
        return self.out_drop(self.to_out(out))


class _InteractiveWindowedSelfAttention(nn.Module):
    """scalable_vit.py:126-194: window attention (a window of None is the
    whole map) plus a parallel 3x3 conv of the values."""

    def __init__(self, dim: int, heads: int, dim_key: int, dim_value: int,
                 window_size: Optional[int], dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_key, self.window = heads, dim_key, window_size
        self.norm = _ln(dim)
        self.to_q = nn.Linear(dim, dim_key * heads, bias=False)
        self.to_k = nn.Linear(dim, dim_key * heads, bias=False)
        self.to_v = nn.Linear(dim, dim_value * heads, bias=False)
        self.lim = ConvCL(dim_value * heads, dim_value * heads, 3, 1, 1)
        self.attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(dim_value * heads, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.heads
        b, height, width, _ = x.shape
        wh, ww = self.window or height, self.window or width
        y = self.norm(x)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        local_out = self.lim(v)
        q, k, v = (_heads(_windows(t, wh, ww), h) for t in (q, k, v))
        out = _attend(q * self.dim_key ** -0.5, k, v, self.attn_drop)
        out = _unwindows(_merge(out), b, height // wh, width // ww, wh, ww)
        return self.out_drop(self.to_out(out + local_out))


class ScalableViT(nn.Module):
    """scalable_vit.py:240-304 in the reference's effective layer order
    (SSA, FF, [PEG on a stage's first layer], FF, IWSA; its forward
    unpacks the module list swapped, scalable_vit.py:217-236); between
    stages LayerNorm and a strided conv; LayerNorm'd mean pool, head."""

    def __init__(self, num_classes: int, dim: int, depth: Sequence[int],
                 heads, reduction_factor, window_size=None,
                 iwsa_dim_key: int = 32, iwsa_dim_value: int = 32,
                 ssa_dim_key: int = 32, ssa_dim_value: int = 32,
                 ff_expansion_factor: int = 4, dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        n = len(depth)
        heads = _tuple_of(heads, n)
        rf = _tuple_of(reduction_factor, n)
        wsz = tuple(window_size) if isinstance(window_size, (tuple, list)) \
            else (window_size,) * n
        self.depth = tuple(depth)
        self.to_patches = ConvCL(channels, dim, 7, 4, 3)
        for s in range(n):
            width = dim * 2 ** s
            for layer in range(depth[s]):
                pre = f"s{s}_l{layer}"
                self.add_module(f"{pre}_ssa", _ScalableSelfAttention(
                    width, heads[s], ssa_dim_key, ssa_dim_value, rf[s],
                    dropout))
                self.add_module(f"{pre}_ff1", _ConvFeedForward(
                    width, ff_expansion_factor, dropout))
                if layer == 0:
                    self.add_module(f"{pre}_peg", _PEG(width))
                self.add_module(f"{pre}_ff2", _ConvFeedForward(
                    width, ff_expansion_factor, dropout))
                self.add_module(f"{pre}_iwsa",
                                _InteractiveWindowedSelfAttention(
                                    width, heads[s], iwsa_dim_key,
                                    iwsa_dim_value, wsz[s], dropout))
            if s < n - 1:
                self.add_module(f"s{s}_out_norm", _ln(width))
                self.add_module(f"s{s}_down", ConvCL(width, width * 2, 3, 2,
                                                     1))
        self.head_norm = _ln(dim * 2 ** (n - 1))
        self.head = nn.Linear(dim * 2 ** (n - 1), num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.to_patches(img)
        for s, depth in enumerate(self.depth):
            for layer in range(depth):
                get = (lambda name: getattr(self, f"s{s}_l{layer}_{name}"))
                x = x + get("ssa")(x)
                x = x + get("ff1")(x)
                if layer == 0:
                    x = get("peg")(x)
                x = x + get("ff2")(x)
                x = x + get("iwsa")(x)
            if s < len(self.depth) - 1:
                x = getattr(self, f"s{s}_down")(
                    getattr(self, f"s{s}_out_norm")(x))
        return self.head_norm(x.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))


# ---------------------------------------------------------------------------
# SepViT (sep_vit.py)
# ---------------------------------------------------------------------------


class _DSSA(nn.Module):
    """sep_vit.py:65-206: window attention with a learned window token per
    window, then (with more than one window) pointwise attention of the
    window tokens across windows re-mixing the windows' value maps."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 window_size: int, dropout: float = 0.0, *,
                 num_windows: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.window = heads, dim_head, window_size
        self.norm = _ln(dim)
        self.window_token = nn.Parameter(torch.empty(dim))
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.attn_drop = Dropout(dropout)
        self.cross = num_windows > 1
        if self.cross:
            self.wt_norm = _ln(dim_head)
            self.wt_to_qk = nn.Linear(inner, inner * 2)
            self.w_attn_drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)
        self.out_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w, dh = self.heads, self.window, self.dim_head
        b, height, width, _ = x.shape
        if height % w or width % w:
            raise ValueError(f"map {height}x{width} not divisible by the "
                             f"window {w}")
        nx, ny = height // w, width // w
        win = _windows(self.norm(x), w, w)
        win = torch.cat([self.window_token.expand(win.shape[0], 1, -1), win],
                        dim=1)
        q, k, v = (_heads(t, h) for t in self.to_qkv(win).chunk(3, dim=-1))
        out = _attend(q * dh ** -0.5, k, v, self.attn_drop)
        window_tokens, fmaps = out[:, :, 0], out[:, :, 1:]
        if self.cross:
            # (b x y) h ... -> b h (x y) ...
            window_tokens = window_tokens.reshape(b, nx * ny, h, dh) \
                .transpose(1, 2)
            fmaps = fmaps.reshape(b, nx * ny, h, w * w, dh).transpose(1, 2)
            wt = _merge(_gelu(self.wt_norm(window_tokens)))
            w_q, w_k = _heads(self.wt_to_qk(wt), h).chunk(2, dim=-1)
            w_attn = torch.softmax(torch.einsum(
                "bhid,bhjd->bhij", w_q * dh ** -0.5, w_k), -1)
            fmaps = torch.einsum("bhij,bhjnd->bhind",
                                 self.w_attn_drop(w_attn), fmaps)
            # b h (x y) (w1 w2) d -> (b x y) (w1 w2) (h d)
            fmaps = fmaps.permute(0, 2, 3, 1, 4).reshape(b * nx * ny, w * w,
                                                         h * dh)
        else:
            fmaps = _merge(fmaps)
        fmap = _unwindows(fmaps, b, nx, ny, w, w)
        return self.out_drop(self.to_out(fmap))


class SepViT(nn.Module):
    """sep_vit.py:237-291: per stage an overlapping strided conv (stride
    4 then 2), a PEG, layers of DSSA + feed-forward, a LayerNorm between
    stages; LayerNorm'd mean pool, head.  ``image_size`` (an int or a
    pair) gives each stage's number of windows."""

    def __init__(self, num_classes: int, dim: int, depth: Sequence[int],
                 heads, window_size=7, dim_head: int = 32, ff_mult: int = 4,
                 dropout: float = 0.0, *, image_size, channels: int = 3):
        super().__init__()
        n = len(depth)
        heads = _tuple_of(heads, n)
        wsz = _tuple_of(window_size, n)
        self.depth = tuple(depth)
        height, width = _pair(image_size)
        cin = channels
        for s in range(n):
            size, stride = dim * 2 ** s, 4 if s == 0 else 2
            k = stride * 2 - 1
            height = (height + 2 * (k // 2) - k) // stride + 1
            width = (width + 2 * (k // 2) - k) // stride + 1
            windows = (height // wsz[s]) * (width // wsz[s])
            self.add_module(f"s{s}_ope", ConvCL(cin, size, k, stride,
                                                k // 2))
            self.add_module(f"s{s}_peg", _PEG(size))
            for layer in range(depth[s]):
                self.add_module(f"s{s}_l{layer}_dssa", _DSSA(
                    size, heads[s], dim_head, wsz[s], dropout,
                    num_windows=windows))
                self.add_module(f"s{s}_l{layer}_ff", _ConvFeedForward(
                    size, ff_mult, dropout))
            if s < n - 1:
                self.add_module(f"s{s}_out_norm", _ln(size))
            cin = size
        self.head_norm = _ln(cin)
        self.head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for s, depth in enumerate(self.depth):
            x = getattr(self, f"s{s}_peg")(getattr(self, f"s{s}_ope")(x))
            for layer in range(depth):
                x = x + getattr(self, f"s{s}_l{layer}_dssa")(x)
                x = x + getattr(self, f"s{s}_l{layer}_ff")(x)
            if s < len(self.depth) - 1:
                x = getattr(self, f"s{s}_out_norm")(x)
        return self.head_norm(x.mean(dim=(1, 2)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(img))
