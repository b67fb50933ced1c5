"""ViT zoo, round 2 (counterpart of ``gfe_mamba_tpu/models/vit_zoo_extra.py``):
SimpleViT3D, ViViT, CCT / CCT3D, CaiT, DeepViT, PiT, T2TViT, CrossViT,
MPP, CvT, NesT and MobileViT.

Channels-last at the API as in JAX: images ``(B, H, W, C)``, videos and
volumes ``(B, F, H, W, C)``.  The JAX classes' fields and defaults; what
flax infers from the input (``channels``, and CCT's ``image_size`` /
``frames``, which size its learned position table) are keyword-only
arguments after them.  Convolutions run on channels-first copies inside
(:class:`ConvCL`), their weights in torch's layout.

``SimpleViT3D``, ``ViViT`` and ``CCT`` carry the vendored reference's
state_dict keys (simple_vit_3d.py, vivit.py, cct.py / cct_3d.py), so
``utils/torch_import.py`` loads its checkpoints with a strict
``load_state_dict``; SimpleViT3D packs each patch in the reference's
``(p1 p2 pf c)`` order for that.  The other models keep the flax module
names (``attn_0``, ``s1_ff2_0``, ...), so their state_dict is the flax
tree with torch layouts (``utils/convert_zoo.py``).

Reference quirks that JAX keeps are kept: CCT's feed-forward residual
rides the ``norm1``-normed tensor; CrossViT sums its two heads;
DeepViT's re-attention norm runs over the key axis.  Stochastic depth
(:class:`DropPath`) and MPP's corruption draw from a ``torch.Generator``
in one small method each, which tests replace with JAX's draws.
MobileViT's BatchNorms are flax's (``ops/blocks.py::BatchNorm``: momentum
0.99 of the old statistics, biased batch variance, eps 1e-5).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit import LN_EPS, Transformer
from gfe_mamba_torch.models.vit_zoo import (Patches, _pair, _prepend,
                                            _patch_embedding, _pool,
                                            patchify)
from gfe_mamba_torch.ops.blocks import BatchNorm


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _add(module: nn.Module, name: str, count: int, make) -> None:
    """Register ``make(i)`` as ``module.<name>_<i>`` for i < count (the
    flax names of a loop's submodules)."""
    for i in range(count):
        module.add_module(f"{name}_{i}", make(i))


class ConvCL(nn.Conv2d):
    """``nn.Conv2d`` on channels-last ``(B, H, W, C)`` tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _posemb_sincos_3d(f: int, h: int, w: int, dim: int,
                      temperature: float = 10000.0) -> torch.Tensor:
    """Fixed 3D sincos table ``(f * h * w, dim)``: dim // 6 frequencies
    per axis, ``[sin x, cos x, sin y, cos y, sin z, cos z]``, zero-padded
    to ``dim``; computed in f64 and rounded to f32, as JAX's numpy does."""
    zs, ys, xs = np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                             indexing="ij")
    fdim = dim // 6
    omega = 1.0 / temperature ** (np.arange(fdim) / max(fdim - 1, 1))
    out = []
    for grid in (xs, ys, zs):
        arg = grid.reshape(-1)[:, None] * omega[None, :]
        out += [np.sin(arg), np.cos(arg)]
    pe = np.concatenate(out, axis=1).astype(np.float32)
    return torch.from_numpy(np.pad(pe, ((0, 0), (0, dim - pe.shape[1]))))


class SimpleViT3D(nn.Module):
    """simple_vit_3d.py over ``(B, F, H, W, C)``: patchify -> LN/Linear/LN
    -> + sincos -> transformer -> mean pool -> linear head."""

    def __init__(self, image_size: Sequence[int], patch_size: Sequence[int],
                 num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, dim_head: int = 64, *, channels: int = 3):
        super().__init__()
        pf, ph, pw = patch_size
        # the reference packs a patch (p1 p2 pf c)
        self.to_patch_embedding = _patch_embedding(
            pf * ph * pw * channels, dim, Patches((pf, ph, pw), (1, 2, 0)))
        grid = [s // p for s, p in zip(image_size, patch_size)]
        self.register_buffer("pos", _posemb_sincos_3d(*grid, dim),
                             persistent=False)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim)
        self.linear_head = nn.Linear(dim, num_classes)

    def features(self, vol: torch.Tensor) -> torch.Tensor:
        x = self.to_patch_embedding(vol) + self.pos.to(vol.dtype)
        return self.transformer(x).mean(dim=1)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        return self.linear_head(self.features(vol))


class ViViT(nn.Module):
    """vivit.py, factorized: tubelet embedding -> a spatial transformer
    per frame -> a temporal transformer -> head; ``pool`` 'cls' (a CLS
    token at each level) or 'mean'.  Input ``(B, frames, H, W, C)``."""

    def __init__(self, image_size: Sequence[int],
                 image_patch_size: Sequence[int], frames: int,
                 frame_patch_size: int, num_classes: int, dim: int,
                 spatial_depth: int, temporal_depth: int, heads: int,
                 mlp_dim: int, dim_head: int = 64, pool: str = "cls",
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        (h, w), (ph, pw) = _pair(image_size), _pair(image_patch_size)
        pf = frame_patch_size
        self.pool = pool
        self.tubelet = (pf, ph, pw)
        self.to_patch_embedding = _patch_embedding(
            pf * ph * pw * channels, dim, nn.Identity())
        self.pos_embedding = nn.Parameter(
            torch.empty(1, frames // pf, (h // ph) * (w // pw), dim))
        if pool == "cls":
            self.spatial_cls_token = nn.Parameter(torch.empty(1, 1, dim))
            self.temporal_cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.dropout = Dropout(emb_dropout)
        self.spatial_transformer = Transformer(dim, spatial_depth, heads,
                                               dim_head, mlp_dim, dropout)
        self.temporal_transformer = Transformer(dim, temporal_depth, heads,
                                                dim_head, mlp_dim, dropout)
        self.mlp_head = nn.Linear(dim, num_classes)

    def features(self, video: torch.Tensor) -> torch.Tensor:
        b = video.shape[0]
        pf, ph, pw = self.tubelet
        f = video.shape[1] // pf
        # b (f pf) (h p1) (w p2) c -> b f (h w) (p1 p2 pf c)
        x = patchify(video, self.tubelet, (1, 2, 0))
        x = x.reshape(b, f, -1, x.shape[-1])
        x = self.to_patch_embedding(x) + self.pos_embedding.to(video.dtype)
        cls = self.pool == "cls"
        if cls:
            tok = self.spatial_cls_token.to(x.dtype)
            x = torch.cat([tok[None].expand(b, f, 1, -1), x], dim=2)
        x = self.dropout(x)
        x = self.spatial_transformer(x.reshape(b * f, *x.shape[2:]))
        x = x.reshape(b, f, *x.shape[1:])
        x = x[:, :, 0] if cls else x.mean(dim=2)
        if cls:
            x = _prepend(self.temporal_cls_token, x)
        return _pool(self.temporal_transformer(x), self.pool)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(video))


class DropPath(Dropout):
    """Per-sample stochastic depth (cct.py ``DropPath``): in train mode
    each sample's branch is kept with probability 1 - p and scaled by
    1 / (1 - p).  A :class:`Dropout`, so ``seed_dropout`` gives it its
    generator and its rows of a data-parallel batch."""

    def keep(self, rows: int, device) -> torch.Tensor:
        """The kept samples of a batch of ``rows``, bool ``(rows,)``."""
        draw = torch.rand(rows * self.data_size, generator=self.generator,
                          device=device)
        return draw[self.data_index * rows:(self.data_index + 1) * rows] \
            < 1.0 - self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in train mode needs a generator: "
                               "call seed_dropout(model, generator)")
        keep = self.keep(x.shape[0], x.device)
        keep = keep.reshape(-1, *(1,) * (x.dim() - 1)).to(x.dtype)
        return x * keep / (1.0 - self.p)


class _ConvTokenizer(nn.Module):
    """CCT tokenizer: [conv (no bias) -> ReLU -> max pool] x n, then the
    map flattened to tokens.  ``dims=3`` gives the frame axis its own
    kernel, stride and pooling (cct_3d.py).  ``conv_layers.<i>.0`` is the
    reference's key of each conv."""

    def __init__(self, n_output_channels: int, n_conv_layers: int,
                 kernel_size: int, stride: int, pooling_kernel_size: int,
                 pooling_stride: int, in_planes: int = 64, dims: int = 2,
                 frame_kernel_size: int = 3, frame_stride: int = 1,
                 frame_pooling_kernel_size: int = 1,
                 frame_pooling_stride: int = 1, *, channels: int = 3):
        super().__init__()
        chans = [channels] + [in_planes] * (n_conv_layers - 1) \
            + [n_output_channels]
        k, s = kernel_size, stride
        pk, ps = pooling_kernel_size, pooling_stride
        if dims == 3:
            conv, pool = nn.Conv3d, nn.MaxPool3d
            kernel, strides = (frame_kernel_size, k, k), (frame_stride, s, s)
            cpad = (frame_kernel_size // 2, k // 2, k // 2)
            pkern = (frame_pooling_kernel_size, pk, pk)
            pstr = (frame_pooling_stride, ps, ps)
            ppad = (frame_pooling_kernel_size // 2, 1, 1)
        else:
            conv, pool = nn.Conv2d, nn.MaxPool2d
            kernel, strides, cpad = (k, k), (s, s), (k // 2, k // 2)
            pkern, pstr, ppad = (pk, pk), (ps, ps), (1, 1)
        self.geometry = (kernel, strides, cpad, pkern, pstr, ppad)
        # torch's max pool pads with -inf, as flax's nn.max_pool does
        self.conv_layers = nn.Sequential(*(
            nn.Sequential(conv(cin, cout, kernel, strides, cpad, bias=False),
                          nn.ReLU(), pool(pkern, pstr, ppad))
            for cin, cout in zip(chans[:-1], chans[1:])))

    def sequence_length(self, size: Sequence[int]) -> int:
        """Tokens out of an input of spatial ``size``."""
        kernel, strides, cpad, pkern, pstr, ppad = self.geometry
        size = list(size)
        for _ in self.conv_layers:
            size = [(n + 2 * p - k) // s + 1
                    for n, k, s, p in zip(size, kernel, strides, cpad)]
            size = [(n + 2 * p - k) // s + 1
                    for n, k, s, p in zip(size, pkern, pstr, ppad)]
        return math.prod(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_layers(x.movedim(-1, 1))
        return x.flatten(2).transpose(1, 2)


def _sinusoidal_embedding(n: int, dim: int) -> torch.Tensor:
    """CCT's 'sine' table ``(1, n, dim)``: position p, channel i ->
    p / 10000^(2 (i // 2) / dim), sin on even channels, cos on odd."""
    pe = np.array([[p / 10000.0 ** (2 * (i // 2) / dim)
                    for i in range(dim)] for p in range(n)], np.float32)
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return torch.from_numpy(pe[None])


class _CCTAttention(nn.Module):
    """CCT attention: fused qkv (no bias), head dim = dim // heads, an
    output projection with bias."""

    def __init__(self, dim: int, heads: int, attention_dropout: float = 0.0,
                 proj_dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.attn_drop = Dropout(attention_dropout)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        q = q * (d // self.heads) ** -0.5
        attn = self.attn_drop(torch.softmax(q @ k.transpose(-1, -2), -1))
        out = (attn @ v).transpose(1, 2).reshape(b, n, d)
        return self.proj_drop(self.proj(out))


class _CCTBlock(nn.Module):
    """TransformerEncoderLayer of cct.py, its reference keys: the
    feed-forward residual rides the ``norm1``-normed tensor."""

    def __init__(self, dim: int, heads: int, hidden: int, dropout: float,
                 attention_dropout: float, drop_path: float):
        super().__init__()
        self.pre_norm = _ln(dim)
        self.self_attn = _CCTAttention(dim, heads, attention_dropout,
                                       dropout)
        self.norm1 = _ln(dim)
        self.linear1 = nn.Linear(dim, hidden)
        self.dropout1 = Dropout(dropout)
        self.linear2 = nn.Linear(hidden, dim)
        self.dropout2 = Dropout(dropout)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop_path1(self.self_attn(self.pre_norm(x))))
        h = self.linear2(self.dropout1(_gelu(self.linear1(x))))
        return x + self.drop_path2(self.dropout2(h))


class _CCTClassifier(nn.Module):
    """cct.py's ``TransformerClassifier``: position table, the blocks, a
    final norm, attention sequence pooling (or the class token) and the
    head."""

    def __init__(self, n: int, num_classes: int, dim: int, num_layers: int,
                 num_heads: int, mlp_ratio: float, stochastic_depth: float,
                 dropout: float, attention_dropout: float,
                 positional_embedding: str, seq_pool: bool):
        super().__init__()
        self.seq_pool = seq_pool
        if not seq_pool:
            self.class_emb = nn.Parameter(torch.empty(1, 1, dim))
            n += 1
        if positional_embedding == "learnable":
            self.positional_emb = nn.Parameter(torch.empty(1, n, dim))
        elif positional_embedding == "sine":
            # recomputed, never read from a checkpoint
            self.register_buffer("positional_emb",
                                 _sinusoidal_embedding(n, dim),
                                 persistent=False)
        else:
            self.positional_emb = None
        self.dropout = Dropout(dropout)
        dpr = np.linspace(0, stochastic_depth, num_layers)
        self.blocks = nn.ModuleList(
            _CCTBlock(dim, num_heads, int(dim * mlp_ratio), dropout,
                      attention_dropout, float(dpr[i]))
            for i in range(num_layers))
        self.norm = _ln(dim)
        if seq_pool:
            self.attention_pool = nn.Linear(dim, 1)
        self.fc = nn.Linear(dim, num_classes)

    def reset_extra(self, generator: torch.Generator) -> None:
        if not self.seq_pool:
            self.class_emb.zero_()
        if isinstance(self.positional_emb, nn.Parameter):
            # flax's truncated_normal(0.2): N(0, 0.2^2) cut at two deviations
            nn.init.trunc_normal_(self.positional_emb, 0.0, 0.2, -0.4, 0.4,
                                  generator=generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        if not self.seq_pool:
            x = _prepend(self.class_emb, x)
        if self.positional_emb is not None:
            x = x + self.positional_emb.to(x.dtype)
        x = self.dropout(x)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        if not self.seq_pool:
            return x[:, 0]
        attn = torch.softmax(self.attention_pool(x), dim=1)     # (B, N, 1)
        return torch.einsum("bnl,bnd->bd", attn, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(x))


class CCT(nn.Module):
    """Compact Convolutional Transformer (cct.py / cct_3d.py): the conv
    tokenizer, then ``classifier`` (:class:`_CCTClassifier`).  2D input
    ``(B, H, W, C)`` with ``image_size`` (H, W); ``dims=3`` input ``(B,
    F, H, W, C)`` with ``frames`` F too."""

    def __init__(self, num_classes: int, embedding_dim: int = 128,
                 n_conv_layers: int = 2, kernel_size: int = 7,
                 stride: int = 2, pooling_kernel_size: int = 3,
                 pooling_stride: int = 2, num_layers: int = 7,
                 num_heads: int = 4, mlp_ratio: float = 2.0,
                 stochastic_depth: float = 0.1, dropout: float = 0.0,
                 attention_dropout: float = 0.1,
                 positional_embedding: str = "learnable",
                 seq_pool: bool = True, dims: int = 2,
                 frame_kernel_size: int = 3, frame_stride: int = 1,
                 frame_pooling_kernel_size: int = 1,
                 frame_pooling_stride: int = 1, *, image_size,
                 frames: int | None = None, channels: int = 3):
        super().__init__()
        self.tokenizer = _ConvTokenizer(
            embedding_dim, n_conv_layers, kernel_size, stride,
            pooling_kernel_size, pooling_stride, dims=dims,
            frame_kernel_size=frame_kernel_size, frame_stride=frame_stride,
            frame_pooling_kernel_size=frame_pooling_kernel_size,
            frame_pooling_stride=frame_pooling_stride, channels=channels)
        size = _pair(image_size) if dims == 2 else (frames,
                                                   *_pair(image_size))
        self.classifier = _CCTClassifier(
            self.tokenizer.sequence_length(size), num_classes,
            embedding_dim, num_layers, num_heads, mlp_ratio,
            stochastic_depth, dropout, attention_dropout,
            positional_embedding, seq_pool)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        return self.classifier.features(self.tokenizer(img))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.tokenizer(img))


def CCT3D(**kwargs) -> CCT:
    """cct_3d.py: :class:`CCT` with the anisotropic 3D tokenizer."""
    return CCT(dims=3, **kwargs)


class _TalkingHeadsAttention(nn.Module):
    """CaiT attention: the logits mixed across heads before the softmax,
    the attention mixed again after it."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.mix_heads_pre = nn.Parameter(torch.empty(heads, heads))
        self.mix_heads_post = nn.Parameter(torch.empty(heads, heads))
        self.drop = Dropout(dropout)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None
                ) -> torch.Tensor:
        context = x if context is None else context
        split = (lambda t: t.reshape(*t.shape[:2], self.heads, -1)
                 .transpose(1, 2))
        q = split(self.to_q(x))
        k, v = (split(t) for t in self.to_kv(context).chunk(2, dim=-1))
        logits = torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head ** -0.5
        logits = torch.einsum("bhij,hg->bgij", logits, self.mix_heads_pre)
        attn = torch.einsum("bhij,hg->bgij", torch.softmax(logits, -1),
                            self.mix_heads_post)
        out = torch.einsum("bhij,bhjd->bhid", self.drop(attn), v)
        return self.to_out(out.transpose(1, 2).reshape(*x.shape[:2], -1))


class _LayerScaleBlock(nn.Module):
    """Pre-norm block with LayerScale (cait.py); ``context`` (the class
    blocks') gets its own norm ``norm_ctx``."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 depth_index: int, dropout: float = 0.0,
                 context: bool = False):
        super().__init__()
        self.depth_index = depth_index
        self.scale_attn = nn.Parameter(torch.empty(dim))
        self.norm1 = _ln(dim)
        if context:
            self.norm_ctx = _ln(dim)
        self.attn = _TalkingHeadsAttention(dim, heads, dim_head, dropout)
        self.scale_ff = nn.Parameter(torch.empty(dim))
        self.norm2 = _ln(dim)
        self.ff1 = nn.Linear(dim, mlp_dim)
        self.drop = Dropout(dropout)
        self.ff2 = nn.Linear(mlp_dim, dim)

    def reset_extra(self, generator: torch.Generator) -> None:
        # cait.py's depth-dependent LayerScale epsilon
        d = self.depth_index
        eps = 0.1 if d < 18 else (1e-5 if d > 24 else 1e-6)
        self.scale_attn.fill_(eps)
        self.scale_ff.fill_(eps)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None
                ) -> torch.Tensor:
        ctx = None if context is None else self.norm_ctx(context)
        x = x + self.attn(self.norm1(x), ctx) * self.scale_attn
        h = self.ff2(self.drop(_gelu(self.ff1(self.norm2(x)))))
        return x + h * self.scale_ff


class CaiT(nn.Module):
    """cait.py: a patch transformer (talking heads + LayerScale), then
    ``cls_depth`` class-attention blocks in which only the CLS token
    queries [CLS, frozen patch tokens], then LayerNorm and the head."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, cls_depth: int, heads: int,
                 mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        p = patch_size
        self.patch = p
        n = (image_size // p) ** 2
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.pos_embedding = nn.Parameter(torch.empty(1, n, dim))
        self.dropout = Dropout(emb_dropout)
        self.depth, self.cls_depth = depth, cls_depth
        _add(self, "block", depth, lambda i: _LayerScaleBlock(
            dim, heads, dim_head, mlp_dim, i + 1, dropout))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        _add(self, "cls_block", cls_depth, lambda i: _LayerScaleBlock(
            dim, heads, dim_head, mlp_dim, depth + i + 1, dropout, True))
        self.norm = _ln(dim)
        self.mlp_head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(patchify(img, (self.patch,) * 2))
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        for i in range(self.cls_depth):
            cls = getattr(self, f"cls_block_{i}")(
                cls, context=torch.cat([cls, x], dim=1))
        return self.norm(cls[:, 0])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class _ReAttention(nn.Module):
    """DeepViT re-attention: the softmaxed maps mixed across heads by a
    learned matrix, then LayerNorm over the key axis (``reattn_norm``)."""

    def __init__(self, dim: int, heads: int, dim_head: int, n: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.reattn_weights = nn.Parameter(torch.empty(heads, heads))
        self.reattn_norm = _ln(n)
        self.to_out = nn.Linear(heads * dim_head, dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k)
                             * self.dim_head ** -0.5, -1)
        attn = torch.einsum("bhij,hg->bgij", attn, self.reattn_weights)
        out = torch.einsum("bhij,bhjd->bhid", self.reattn_norm(attn), v)
        return self.drop(self.to_out(out.transpose(1, 2).reshape(b, n, -1)))


class DeepViT(nn.Module):
    """deepvit.py: the ViT classifier with re-attention blocks."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int,
                 dim_head: int = 64, pool: str = "cls", dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        p = patch_size
        self.patch, self.pool, self.depth = p, pool, depth
        n = (image_size // p) ** 2
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.dropout = Dropout(emb_dropout)
        _add(self, "norm1", depth, lambda i: _ln(dim))
        _add(self, "attn", depth, lambda i: _ReAttention(
            dim, heads, dim_head, n + 1, dropout))
        _add(self, "norm2", depth, lambda i: _ln(dim))
        _add(self, "ff1", depth, lambda i: nn.Linear(dim, mlp_dim))
        _add(self, "ff2", depth, lambda i: nn.Linear(mlp_dim, dim))
        self.ff_drop = Dropout(dropout)
        self.mlp_head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(patchify(img, (self.patch,) * 2))
        x = self.dropout(_prepend(self.cls_token, x)
                         + self.pos_embedding.to(x.dtype))
        for i in range(self.depth):
            layer = (lambda name: getattr(self, f"{name}_{i}"))
            x = x + layer("attn")(layer("norm1")(x))
            h = self.ff_drop(_gelu(layer("ff1")(layer("norm2")(x))))
            x = x + layer("ff2")(h)
        return _pool(x, self.pool)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


def _unfold2d(x: torch.Tensor, k: int, stride: int,
              padding: int) -> torch.Tensor:
    """torch ``nn.Unfold`` on channels-last ``(B, H, W, C)`` -> ``(B, N,
    C * k * k)`` tokens, features channel-major as ``F.unfold`` and JAX's
    ``conv_general_dilated_patches`` order them."""
    return F.unfold(x.permute(0, 3, 1, 2), k, padding=padding,
                    stride=stride).transpose(1, 2)


class PiT(nn.Module):
    """Pooling-based ViT (pit.py): an overlapping unfold embedding
    (stride p // 2), transformer stages separated by a pool (depthwise
    stride-2 conv on the token grid, Linear on CLS; the width doubles)."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, depth: Sequence[int], heads: Sequence[int],
                 mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        p = patch_size
        self.patch = p
        side = (image_size - p) // (p // 2) + 1
        self.patch_embed = nn.Linear(p * p * channels, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, side * side + 1,
                                                      dim))
        self.dropout = Dropout(emb_dropout)
        self.stages = len(depth)
        width = dim
        for i, (d, h) in enumerate(zip(depth, heads)):
            self.add_module(f"stage_{i}", Transformer(width, d, h, dim_head,
                                                      mlp_dim, dropout))
            if i < self.stages - 1:
                self.add_module(f"pool_cls_{i}", nn.Linear(width, 2 * width))
                self.add_module(f"pool_conv_{i}", ConvCL(
                    width, 2 * width, 3, 2, 1, groups=width))
                width *= 2
        self.head_norm = _ln(width)
        self.mlp_head = nn.Linear(width, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(_unfold2d(img, self.patch, self.patch // 2, 0))
        b, n, dim = x.shape
        side = int(round(n ** 0.5))
        x = self.dropout(_prepend(self.cls_token, x)
                         + self.pos_embedding.to(x.dtype))
        for i in range(self.stages):
            x = getattr(self, f"stage_{i}")(x)
            if i < self.stages - 1:
                cls_t = getattr(self, f"pool_cls_{i}")(x[:, :1])
                grid = getattr(self, f"pool_conv_{i}")(
                    x[:, 1:].reshape(b, side, side, dim))
                side, dim = grid.shape[1], grid.shape[-1]
                x = torch.cat([cls_t, grid.reshape(b, side * side, dim)], 1)
        return self.head_norm(x[:, 0])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class T2TViT(nn.Module):
    """Tokens-to-Token ViT (t2t.py): progressive soft splits (unfold)
    with one-head transformers between them, then a CLS ViT backbone."""

    def __init__(self, image_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 pool: str = "cls",
                 t2t_layers: Sequence[Sequence[int]] = ((7, 4), (3, 2),
                                                        (3, 2)),
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        self.pool, self.t2t_layers = pool, tuple(map(tuple, t2t_layers))
        layer_dim, size = channels, image_size
        for i, (k, s) in enumerate(self.t2t_layers):
            layer_dim *= k * k
            size = (size + 2 * (s // 2) - k) // s + 1
            if i < len(self.t2t_layers) - 1:
                self.add_module(f"t2t_{i}", Transformer(
                    layer_dim, 1, 1, layer_dim, layer_dim, dropout))
        self.t2t_project = nn.Linear(layer_dim, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, size * size + 1,
                                                      dim))
        self.dropout = Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.head_norm = _ln(dim)
        self.mlp_head = nn.Linear(dim, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for i, (k, s) in enumerate(self.t2t_layers):
            if i > 0:       # tokens -> image
                side = int(round(x.shape[1] ** 0.5))
                x = x.reshape(x.shape[0], side, side, x.shape[-1])
            x = _unfold2d(x, k, s, s // 2)
            if i < len(self.t2t_layers) - 1:
                x = getattr(self, f"t2t_{i}")(x)
        x = self.t2t_project(x)
        x = self.dropout(_prepend(self.cls_token, x)
                         + self.pos_embedding.to(x.dtype))
        return self.head_norm(_pool(self.transformer(x), self.pool))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class _CrossAttendOnce(nn.Module):
    """One CrossViT exchange: a branch's CLS projected to the other
    branch's width attends over [itself, the other branch's patch tokens]
    and is projected back (ProjectInOut)."""

    def __init__(self, dim_a: int, dim_b: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.proj_in = nn.Linear(dim_a, dim_b)
        self.norm = _ln(dim_b)
        self.to_q = nn.Linear(dim_b, inner, bias=False)
        self.to_kv = nn.Linear(dim_b, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim_b)
        self.proj_out = nn.Linear(dim_b, dim_a)

    def forward(self, cls_a: torch.Tensor,
                tokens_b: torch.Tensor) -> torch.Tensor:
        q_in = self.proj_in(cls_a)
        ctx = torch.cat([q_in, tokens_b], dim=1)
        split = (lambda t: t.reshape(*t.shape[:2], self.heads, -1)
                 .transpose(1, 2))
        q = split(self.to_q(self.norm(q_in)))
        k, v = (split(t) for t in self.to_kv(ctx).chunk(2, dim=-1))
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k)
                             * self.dim_head ** -0.5, -1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = self.to_out(out.transpose(1, 2).reshape(*q_in.shape[:2], -1))
        return cls_a + self.proj_out(q_in + out)


class CrossViT(nn.Module):
    """Dual-branch multi-scale ViT (cross_vit.py): small- and
    large-patch branches with their own transformers exchange CLS tokens
    by projected cross-attention; the two heads' logits are summed."""

    def __init__(self, image_size: int, num_classes: int,
                 sm_patch_size: int = 4, lg_patch_size: int = 8,
                 sm_dim: int = 64, lg_dim: int = 96, sm_enc_depth: int = 1,
                 lg_enc_depth: int = 1, cross_attn_depth: int = 1,
                 multi_scale_enc_depth: int = 2, heads: int = 4,
                 dim_head: int = 32, mlp_mult: int = 2,
                 dropout: float = 0.0, emb_dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        self.patches = (sm_patch_size, lg_patch_size)
        self.depths = (multi_scale_enc_depth, cross_attn_depth)
        for tag, p, dim, enc in (("sm", sm_patch_size, sm_dim, sm_enc_depth),
                                 ("lg", lg_patch_size, lg_dim,
                                  lg_enc_depth)):
            n = (image_size // p) ** 2
            self.add_module(f"{tag}_patch_embed",
                            nn.Linear(p * p * channels, dim))
            self.register_parameter(f"{tag}_cls_token",
                                    nn.Parameter(torch.empty(1, 1, dim)))
            self.register_parameter(f"{tag}_pos_embedding",
                                    nn.Parameter(torch.empty(1, n + 1, dim)))
            _add(self, f"{tag}_enc", multi_scale_enc_depth,
                 lambda i: Transformer(dim, enc, heads, dim_head,
                                       dim * mlp_mult, dropout))
            self.add_module(f"{tag}_norm", _ln(dim))
            self.add_module(f"{tag}_mlp_head", nn.Linear(dim, num_classes))
        for i in range(multi_scale_enc_depth):
            for j in range(cross_attn_depth):
                self.add_module(f"sm_attend_lg_{i}_{j}", _CrossAttendOnce(
                    sm_dim, lg_dim, heads, dim_head, dropout))
                self.add_module(f"lg_attend_sm_{i}_{j}", _CrossAttendOnce(
                    lg_dim, sm_dim, heads, dim_head, dropout))
        self.dropout = Dropout(emb_dropout)

    def _embed(self, img: torch.Tensor, tag: str, p: int) -> torch.Tensor:
        x = getattr(self, f"{tag}_patch_embed")(patchify(img, (p, p)))
        x = _prepend(getattr(self, f"{tag}_cls_token"), x)
        return self.dropout(x + getattr(self, f"{tag}_pos_embedding")
                            .to(x.dtype))

    def features(self, img: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The two branches' normed CLS tokens."""
        sm = self._embed(img, "sm", self.patches[0])
        lg = self._embed(img, "lg", self.patches[1])
        for i in range(self.depths[0]):
            sm = getattr(self, f"sm_enc_{i}")(sm)
            lg = getattr(self, f"lg_enc_{i}")(lg)
            for j in range(self.depths[1]):
                sm_cls = getattr(self, f"sm_attend_lg_{i}_{j}")(sm[:, :1],
                                                               lg[:, 1:])
                lg_cls = getattr(self, f"lg_attend_sm_{i}_{j}")(lg[:, :1],
                                                               sm[:, 1:])
                sm = torch.cat([sm_cls, sm[:, 1:]], dim=1)
                lg = torch.cat([lg_cls, lg[:, 1:]], dim=1)
        return self.sm_norm(sm[:, 0]), self.lg_norm(lg[:, 0])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        sm, lg = self.features(img)
        return self.sm_mlp_head(sm) + self.lg_mlp_head(lg)


class MPP(nn.Module):
    """Masked patch prediction (mpp.py): mask a ceil(mask_prob * N) patch
    subset, corrupt it (a random other patch with ``random_patch_prob``,
    the mask token with ``replace_prob``), run a CLS ViT trunk and
    classify each masked patch's discretized mean colour
    (``output_channel_bits`` bins per channel).  ``forward(img,
    generator)`` returns the loss; its draws come from :meth:`draws`."""

    def __init__(self, image_size: int, patch_size: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, channels: int = 1,
                 dim_head: int = 64, mask_prob: float = 0.15,
                 replace_prob: float = 0.5, random_patch_prob: float = 0.5,
                 output_channel_bits: int = 3, max_pixel_val: float = 1.0,
                 dropout: float = 0.0):
        super().__init__()
        p = patch_size
        self.patch, self.channels = p, channels
        n = (image_size // p) ** 2
        pd = p * p * channels
        self.n_masked = int(np.ceil(mask_prob * n))
        self.replace_prob = replace_prob
        self.random_patch_prob = random_patch_prob
        self.n_bins = 2 ** output_channel_bits
        self.max_pixel_val = max_pixel_val
        self.mask_token = nn.Parameter(torch.empty(1, 1, pd))
        self.patch_to_emb = nn.Linear(pd, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n + 1, dim))
        self.dropout = Dropout(dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim,
                                       dropout)
        self.to_bits = nn.Linear(dim, self.n_bins ** channels)

    @staticmethod
    def draws(b: int, n: int, generator: torch.Generator, device
              ) -> tuple[torch.Tensor, ...]:
        """The masking noise, the random patches' indices and the two
        coins' uniforms, each ``(b, n)``."""
        def uniform():
            return torch.rand(b, n, generator=generator, device=device)
        noise = uniform()
        idx = torch.randint(0, n, (b, n), generator=generator, device=device)
        return noise, idx, uniform(), uniform()

    def forward(self, img: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        p, c = self.patch, self.channels
        patches = patchify(img, (p, p))
        b, n, _ = patches.shape
        noise, idx, u1, u2 = self.draws(b, n, generator, img.device)
        # the top ceil(prob * n) of the noise (get_mask_subset_with_prob)
        mask = (-noise).argsort(dim=-1).argsort(dim=-1) < self.n_masked
        corrupted = patches
        if self.random_patch_prob > 0:
            coin = u1 < self.random_patch_prob / (1 - self.replace_prob)
            shuffled = torch.gather(patches, 1, idx[..., None].expand(
                -1, -1, patches.shape[-1]))
            corrupted = torch.where((mask & coin)[..., None], shuffled,
                                    corrupted)
        corrupted = torch.where((mask & (u2 < self.replace_prob))[..., None],
                                self.mask_token.to(img.dtype), corrupted)
        x = _prepend(self.cls_token, self.patch_to_emb(corrupted))
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        logits = self.to_bits(self.transformer(x))[:, 1:]
        # the discretized mean-colour target
        avg = img.reshape(b, img.shape[1] // p, p, img.shape[2] // p, p, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, n, p * p, c).mean(dim=2)
        avg = avg.clamp(max=self.max_pixel_val)
        bin_size = self.max_pixel_val / self.n_bins
        edges = torch.arange(bin_size, self.max_pixel_val, bin_size,
                             device=img.device, dtype=img.dtype)
        disc = torch.searchsorted(edges, avg.contiguous())      # (b, n, c)
        weights = self.n_bins ** torch.arange(c, device=img.device)
        labels = (disc * weights).sum(dim=-1)
        ce = -torch.gather(F.log_softmax(logits, -1), -1,
                           labels[..., None])[..., 0]
        return (ce * mask).sum() / mask.sum().clamp(min=1)


class _CvTAttention(nn.Module):
    """CvT attention: depthwise-conv q and kv projections (kv strided),
    attention over the spatial tokens, a 1x1 conv out."""

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int,
                 heads: int, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner, pk = heads * dim_head, proj_kernel
        self.heads, self.dim_head = heads, dim_head
        self.norm = _ln(dim)
        self.to_q_dw = ConvCL(dim, dim, pk, 1, pk // 2, groups=dim,
                              bias=False)
        self.to_q_pw = ConvCL(dim, inner, 1, bias=False)
        self.to_kv_dw = ConvCL(dim, dim, pk, kv_proj_stride, pk // 2,
                               groups=dim, bias=False)
        self.to_kv_pw = ConvCL(dim, 2 * inner, 1, bias=False)
        self.drop = Dropout(dropout)
        self.to_out = ConvCL(inner, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        xn = self.norm(x)
        split = (lambda t: t.reshape(b, -1, self.heads, self.dim_head)
                 .transpose(1, 2))
        q = split(self.to_q_pw(self.to_q_dw(xn)))
        k, v = (split(t) for t in
                self.to_kv_pw(self.to_kv_dw(xn)).chunk(2, dim=-1))
        attn = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k)
                             * self.dim_head ** -0.5, -1)
        out = torch.einsum("bhij,bhjd->bhid", self.drop(attn), v)
        return self.to_out(out.transpose(1, 2).reshape(b, hh, ww, -1))


class CvT(nn.Module):
    """Convolutional vision Transformer (cvt.py): stages of [strided conv
    embedding -> LN -> transformer with conv projections], a mean-pooled
    linear head."""

    def __init__(self, num_classes: int,
                 emb_dims: Sequence[int] = (64, 192, 384),
                 emb_kernels: Sequence[int] = (7, 3, 3),
                 emb_strides: Sequence[int] = (4, 2, 2),
                 proj_kernel: int = 3,
                 kv_proj_strides: Sequence[int] = (2, 2, 2),
                 heads: Sequence[int] = (1, 3, 6),
                 depths: Sequence[int] = (1, 2, 3), mlp_mult: int = 4,
                 dim_head: int = 64, dropout: float = 0.0, *,
                 channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        cin = channels
        for s, dim in enumerate(emb_dims):
            k = emb_kernels[s]
            self.add_module(f"s{s}_embed", ConvCL(cin, dim, k, emb_strides[s],
                                                  k // 2))
            self.add_module(f"s{s}_norm", _ln(dim))
            for d in range(depths[s]):
                self.add_module(f"s{s}_attn_{d}", _CvTAttention(
                    dim, proj_kernel, kv_proj_strides[s], heads[s], dim_head,
                    dropout))
                self.add_module(f"s{s}_ffnorm_{d}", _ln(dim))
                self.add_module(f"s{s}_ff1_{d}", ConvCL(dim, dim * mlp_mult,
                                                        1))
                self.add_module(f"s{s}_ff2_{d}", ConvCL(dim * mlp_mult, dim,
                                                        1))
            cin = dim
        self.mlp_head = nn.Linear(cin, num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = img
        for s, depth in enumerate(self.depths):
            layer = (lambda name: getattr(self, f"s{s}_{name}"))
            x = layer("norm")(layer("embed")(x))
            for d in range(depth):
                x = x + layer(f"attn_{d}")(x)
                h = _gelu(layer(f"ff1_{d}")(layer(f"ffnorm_{d}")(x)))
                x = x + layer(f"ff2_{d}")(h)
        return x.mean(dim=(1, 2))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class NesT(nn.Module):
    """Nested Transformer (nest.py): a patch embedding, then per level
    the map cut into 2^level x 2^level blocks, a local transformer in each
    block, the blocks put back and aggregated (conv + LN + max pool) down;
    a mean-pooled head."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int,
                 dim: int, heads: int, num_hierarchies: int,
                 block_repeats: Sequence[int], mlp_mult: int = 4,
                 dropout: float = 0.0, *, channels: int = 3):
        super().__init__()
        p = patch_size
        self.patch, self.heads = p, heads
        self.hier = list(reversed(range(num_hierarchies)))
        self.dims = [dim * 2 ** i for i in reversed(self.hier)]
        self.block_repeats = tuple(block_repeats)
        self.patch_norm1 = _ln(p * p * channels)
        self.patch_embed = ConvCL(p * p * channels, self.dims[0], 1)
        self.patch_norm2 = _ln(self.dims[0])
        side = image_size // p
        for li, level in enumerate(self.hier):
            width = self.dims[li]
            local = side // 2 ** level
            self.register_parameter(f"pos_emb_{li}", nn.Parameter(
                torch.empty(local * local)))
            for d in range(block_repeats[li]):
                for name, mod in (
                        ("norm1", _ln(width)),
                        ("qkv", nn.Linear(width, 3 * width, bias=False)),
                        ("attnout", nn.Linear(width, width)),
                        ("norm2", _ln(width)),
                        ("ff1", nn.Linear(width, width * mlp_mult)),
                        ("ff2", nn.Linear(width * mlp_mult, width))):
                    self.add_module(f"l{li}_{name}_{d}", mod)
            if level != 0:
                self.add_module(f"aggregate_{li}", ConvCL(
                    width, self.dims[li + 1], 3, 1, 1))
                self.add_module(f"agg_norm_{li}", _ln(self.dims[li + 1]))
                side //= 2
        self.head_norm = _ln(self.dims[-1])
        self.mlp_head = nn.Linear(self.dims[-1], num_classes)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, hh, ww = img.shape[0], img.shape[1] // p, img.shape[2] // p
        x = patchify(img, (p, p)).reshape(b, hh, ww, -1)
        x = self.patch_norm2(self.patch_embed(self.patch_norm1(x)))
        for li, level in enumerate(self.hier):
            bs = 2 ** level
            b, hh, ww, dim = x.shape
            h, w = hh // bs, ww // bs
            # b (b1 h) (b2 w) d -> (b b1 b2) h w d
            x = x.reshape(b, bs, h, bs, w, dim).permute(0, 1, 3, 2, 4, 5) \
                .reshape(b * bs * bs, h, w, dim)
            x = x + getattr(self, f"pos_emb_{li}").reshape(1, h, w, 1)
            nh = max(1, self.heads * (dim // self.dims[0]))
            for d in range(self.block_repeats[li]):
                layer = (lambda name: getattr(self, f"l{li}_{name}_{d}"))
                t = layer("norm1")(x).reshape(x.shape[0], h * w, dim)
                q, k, v = (u.reshape(u.shape[0], h * w, nh, -1)
                           .transpose(1, 2)
                           for u in layer("qkv")(t).chunk(3, dim=-1))
                attn = torch.softmax(torch.einsum("bhie,bhje->bhij", q, k)
                                     * (dim // nh) ** -0.5, -1)
                o = torch.einsum("bhij,bhje->bhie", attn, v)
                o = o.transpose(1, 2).reshape(x.shape[0], h, w, dim)
                x = x + layer("attnout")(o)
                x = x + layer("ff2")(_gelu(layer("ff1")(layer("norm2")(x))))
            x = x.reshape(b, bs, bs, h, w, dim).permute(0, 1, 3, 2, 4, 5) \
                .reshape(b, hh, ww, dim)
            if level != 0:
                x = getattr(self, f"agg_norm_{li}")(
                    getattr(self, f"aggregate_{li}")(x))
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1) \
                    .permute(0, 2, 3, 1)
        return self.head_norm(x).mean(dim=(1, 2))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))


class _ConvBnSiLU(nn.Module):
    """conv_nxn_bn / conv_1x1_bn of mobile_vit.py: conv -> BN -> SiLU."""

    def __init__(self, cin: int, features: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = ConvCL(cin, features, kernel, stride, kernel // 2,
                           groups=groups, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class _MV2Block(nn.Module):
    """MobileNetV2 inverted residual (mobile_vit.py)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        hidden = cin * expansion
        self.residual = stride == 1 and cin == features
        if expansion != 1:
            self.pw = _ConvBnSiLU(cin, hidden, 1)
        self.dw = _ConvBnSiLU(hidden, hidden, 3, stride, groups=hidden)
        self.pw_linear = ConvCL(hidden, features, 1, bias=False)
        self.bn_out = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pw(x) if hasattr(self, "pw") else x
        h = self.bn_out(self.pw_linear(self.dw(h)))
        return h + x if self.residual else h


class _MobileViTBlock(nn.Module):
    """A local conv, a transformer over the unfolded patches (4 heads of
    8), and the fusion with the block's input (mobile_vit.py)."""

    def __init__(self, cin: int, dim: int, depth: int, channel: int,
                 kernel_size: int, patch_size: Sequence[int], mlp_dim: int):
        super().__init__()
        self.patch = tuple(patch_size)
        self.conv1 = _ConvBnSiLU(cin, channel, kernel_size)
        self.conv2 = _ConvBnSiLU(channel, dim, 1)
        self.transformer = Transformer(dim, depth, 4, 8, mlp_dim)
        self.conv3 = _ConvBnSiLU(dim, channel, 1)
        self.conv4 = _ConvBnSiLU(channel + cin, channel, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.patch
        h = self.conv2(self.conv1(x))
        b, hh, ww, d = h.shape
        # b (h ph) (w pw) d -> (b ph pw) (h w) d
        h = h.reshape(b, hh // ph, ph, ww // pw, pw, d) \
            .permute(0, 2, 4, 1, 3, 5).reshape(b * ph * pw, -1, d)
        h = self.transformer(h).reshape(b, ph, pw, hh // ph, ww // pw, d) \
            .permute(0, 3, 1, 4, 2, 5).reshape(b, hh, ww, d)
        return self.conv4(torch.cat([self.conv3(h), x], dim=-1))


class MobileViT(nn.Module):
    """MobileViT (mobile_vit.py): an MV2 stem, three MV2-downsample +
    MobileViT-block stages, a 1x1 conv head, mean pool, a bias-free
    Linear.  Train mode normalizes by the batch statistics and moves the
    running ones."""

    def __init__(self, image_size: Sequence[int], dims: Sequence[int],
                 channels: Sequence[int], num_classes: int,
                 expansion: int = 4, kernel_size: int = 3,
                 patch_size: Sequence[int] = (2, 2),
                 depths: Sequence[int] = (2, 4, 3), *,
                 in_channels: int = 3):
        super().__init__()
        ch = list(channels)
        self.conv1 = _ConvBnSiLU(in_channels, ch[0], 3, 2)
        self.stem0 = _MV2Block(ch[0], ch[1], 1, expansion)
        self.stem1 = _MV2Block(ch[1], ch[2], 2, expansion)
        self.stem2 = _MV2Block(ch[2], ch[3], 1, expansion)
        self.stem3 = _MV2Block(ch[3], ch[3], 1, expansion)
        cin = ch[3]
        for s in range(3):
            self.add_module(f"trunk{s}_mv2", _MV2Block(
                cin, ch[3 + 2 * s + 1], 2, expansion))
            cin = ch[3 + 2 * s + 1]
            self.add_module(f"trunk{s}_vit", _MobileViTBlock(
                cin, dims[s], depths[s], ch[3 + 2 * s + 2], kernel_size,
                patch_size, int(dims[s] * (2 if s == 0 else 4))))
            cin = ch[3 + 2 * s + 2]
        self.head_conv = _ConvBnSiLU(cin, ch[-1], 1)
        self.mlp_head = nn.Linear(ch[-1], num_classes, bias=False)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        x = self.conv1(img)
        for name in ("stem0", "stem1", "stem2", "stem3"):
            x = getattr(self, name)(x)
        for s in range(3):
            x = getattr(self, f"trunk{s}_vit")(
                getattr(self, f"trunk{s}_mv2")(x))
        return self.head_conv(x).mean(dim=(1, 2))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.features(img))
