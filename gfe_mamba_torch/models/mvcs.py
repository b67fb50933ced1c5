"""The MVCS baseline classifier (counterpart of
``gfe_mamba_tpu/models/mvcs.py``; reference cross_atten/Ours.py),
channels-last ``(B, D, H, W, C)``.

Per-slice SSA (pixel and channel attention summed, then attention across
the slices), three-view SADA attention with pairwise cross-view
attention, MVCS conv blocks and a pooled MLP head, with the JAX
package's module names (``LF0``, ``a01``, ``to_qkv``, ``norm0``, ...).

As in JAX: ``gelu`` is the tanh approximation (flax ``nn.gelu``'s
default); the instance norms are flax's ``GroupNorm(group_size=1)`` (eps
1e-6, var = E[x^2] - E[x]^2); the attention is plain matmuls and
softmax; the convs are cuDNN's (1x1 convs a channel matmul); and
every dropout is 0.2, each block's own default (JAX's ``MVCSNet`` takes
a ``drop_rate`` it never reads; the port takes none).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.ops.blocks import DotConv1x1, InstanceNorm
from gfe_mamba_torch.ops.conv3d import on_channels_first, pool_nd


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _norm(channels: int) -> InstanceNorm:
    return InstanceNorm(channels, channels_last=True)


class SSA(nn.Module):
    """Pixel and channel attention within each slice of ``(B, T, H, W,
    C)``, summed, then attention across the T slices with queries and
    keys from a (3, 1, 1) conv over T."""

    def __init__(self, channels: int):
        super().__init__()
        self.to_qkv = DotConv1x1(channels, 3 * channels, bias=True, dims=2)
        self.to_temporal_qk = nn.Conv3d(channels, 2 * channels, (3, 1, 1),
                                        padding=(1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        q, k, v = self.to_qkv(x.reshape(b * t, h * w, c)).split(c, dim=-1)
        scale = c ** -0.5
        pixel = torch.softmax(q @ k.transpose(1, 2) * scale, dim=-1) @ v
        chan = torch.softmax(q.transpose(1, 2) @ k * scale, dim=-1)
        x_hat = (pixel + v @ chan.transpose(1, 2)).reshape(b, t, h, w, c)
        tq, tk = on_channels_first(self.to_temporal_qk, x_hat).split(
            c, dim=-1)
        # "b t h w c -> b t (c h w)" for the queries and keys,
        # "(b t) hw c -> b t (hw c)" for the values, as in JAX
        tq = tq.permute(0, 1, 4, 2, 3).reshape(b, t, -1)
        tk = tk.permute(0, 1, 4, 2, 3).reshape(b, t, -1)
        attn = torch.softmax(tq @ tk.transpose(1, 2), dim=-1)
        return (attn @ v.reshape(b, t, -1)).reshape(b, t, h, w, c)


class CrossViewAttention(nn.Module):
    """Multi-head attention of one view's per-slice spatial means over
    another's, broadcast back over the spatial dims: ``(B, T, 1, 1, C)``."""

    def __init__(self, channels: int, heads: int = 4, dropout: float = 0.2):
        super().__init__()
        self.heads = heads
        self.d_head = max(channels // heads, 1)
        inner = heads * self.d_head
        self.q = nn.Linear(channels, inner)
        self.k = nn.Linear(channels, inner)
        self.v = nn.Linear(channels, inner)
        self.out = nn.Linear(inner, channels)
        self.drop = Dropout(dropout)

    def _split(self, m: torch.Tensor) -> torch.Tensor:
        b, t, _ = m.shape
        return m.reshape(b, t, self.heads, self.d_head).transpose(1, 2)

    def forward(self, q_view: torch.Tensor,
                kv_view: torch.Tensor) -> torch.Tensor:
        q_tok, kv_tok = q_view.mean((2, 3)), kv_view.mean((2, 3))
        q = self._split(self.q(q_tok))
        k = self._split(self.k(kv_tok))
        v = self._split(self.v(kv_tok))
        attn = torch.softmax(q @ k.transpose(-1, -2)
                             / math.sqrt(self.d_head), dim=-1)
        out = self.drop(attn) @ v
        b, _, t, _ = out.shape
        out = self.out(out.transpose(1, 2).reshape(b, t, -1))
        return out[:, :, None, None, :]


class SADAAttention(nn.Module):
    """SSA along each of the three spatial axes, then pairwise cross-view
    attention; the cross terms are JAX's as written (``a20`` and ``a21``
    both take view 1 as keys and values)."""

    def __init__(self, channels: int, heads: int = 4, dropout: float = 0.2):
        super().__init__()
        for i in range(3):
            self.add_module(f"LF{i}", SSA(channels))
        for name in ("a01", "a02", "a10", "a12", "a20", "a21"):
            self.add_module(name, CrossViewAttention(channels, heads,
                                                     dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.LF0(x)
        x1 = self.LF1(x.movedim(2, 1)).movedim(1, 2)
        x2 = self.LF2(x.movedim(3, 1)).movedim(1, 3)
        x0 = self.a01(x0, x1) + x0 + self.a02(x0, x2)
        x1 = self.a10(x1, x0) + x1 + self.a12(x1, x2)
        x2 = self.a20(x2, x1) + x2 + self.a21(x2, x1)
        return x0 + x1 + x2


class MVCSBlock(nn.Module):
    """1x1x1 conv + norm + gelu, SADA when ``atten``, 3x3x3 conv + norm +
    gelu."""

    def __init__(self, in_channels: int, out_channels: int, heads: int,
                 atten: bool):
        super().__init__()
        self.conv0 = DotConv1x1(in_channels, out_channels, bias=False)
        self.norm0 = _norm(out_channels)
        self.sada = SADAAttention(out_channels, heads) if atten else None
        self.conv2 = nn.Conv3d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.norm2 = _norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.norm0(self.conv0(x)))
        if self.sada is not None:
            x = self.sada(x)
        return gelu(self.norm2(on_channels_first(self.conv2, x)))


class MVCSBlocks(nn.Module):
    """Two MVCSBlocks with dropout between them, plus a 1x1x1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int, heads: int,
                 atten: Sequence[bool] = (False, False),
                 dropout: float = 0.2):
        super().__init__()
        self.shortcut = DotConv1x1(in_channels, out_channels, bias=False)
        self.shortcut_norm = _norm(out_channels)
        self.block0 = MVCSBlock(in_channels, out_channels, heads, atten[0])
        self.drop = Dropout(dropout)
        self.block1 = MVCSBlock(out_channels, out_channels, heads, atten[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = gelu(self.shortcut_norm(self.shortcut(x)))
        h = self.block1(self.drop(self.block0(x)))
        return h + residual


class MVCSNet(nn.Module):
    """Input conv + norm + gelu, then three (average pool 2, MVCSBlocks)
    levels at 2, 4 and 8 times ``base_channel`` (SADA in the last two),
    global average pool, and a two-layer gelu head."""

    def __init__(self, num_classes: int = 1, base_channel: int = 64,
                 num_head: Sequence[int] = (16, 8, 4, 2),
                 in_channels: int = 1):
        super().__init__()
        bc = base_channel
        self.input = nn.Conv3d(in_channels, bc, 3, padding=1, bias=False)
        self.input_norm = _norm(bc)
        self.conv0 = MVCSBlocks(bc, bc * 2, num_head[0], (False, False))
        self.conv1 = MVCSBlocks(bc * 2, bc * 4, num_head[1], (True, True))
        self.conv2 = MVCSBlocks(bc * 4, bc * 8, num_head[2], (True, True))
        self.head1 = nn.Linear(bc * 8, bc * 4)
        self.head2 = nn.Linear(bc * 4, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The globally pooled features ``(B, 8 * base_channel)`` that the
        head reads."""
        x = gelu(self.input_norm(on_channels_first(self.input, x)))
        for level in (self.conv0, self.conv1, self.conv2):
            x = level(pool_nd(x, "avg", 2))
        return x.mean((1, 2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head2(gelu(self.head1(self.features(x))))
