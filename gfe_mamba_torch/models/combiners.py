"""Generator features -> classifier tokens (counterpart of
``gfe_mamba_tpu/models/combiners.py``; reference classify/classifier.py),
channels-last.

``CombineClassifierVitMid`` is the main path's combiner.  The legacy
pyramid combiners (``Combine_classfier_*``, classifier.py:144-370) pool
pairs of encoder and decoder skips through strided conv stacks
(``StridedConv``, SingleConv_modi): ``CombineClassifier``,
``CombineClassifierCross``, ``CombineClassifierEmb``,
``CombineClassifierFused``, ``CombineClassifier2`` and
``CombineClassifier3`` (alias ``CombinePyramid``), with the JAX package's
module names (``extract.extract_0``, ``gn_1``, ``feature3_conv``,
``fully_con``, ``patch_embbeder``).  Where flax infers a width from its
input, the port takes it at construction: ``in_channels`` are the widths
of the two concatenated skip pairs (the canonical generator's 64 + 64 and
128 + 128 by default), and the heads over a flattened pyramid take the
first pair's ``spatial`` extent.  Their GroupNorms are flax's (eps 1e-6)
and ``gelu`` is the tanh approximation, as in JAX; the convs are
cuDNN's.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.ops.blocks import GroupNorm
from gfe_mamba_torch.ops.conv3d import on_channels_first

FLAX_GN_EPS = 1e-6   # flax nn.GroupNorm's default
SKIP_CHANNELS = (128, 256)


class CombineClassifierVitMid(nn.Module):
    """``(B,H,W,C)`` mid_input and mid_output -> ``(B, seq_length, 2C)``:
    concat on channels, flatten the map, project H*W -> seq_length."""

    def __init__(self, mid_hw: int, seq_length: int = 1):
        super().__init__()
        self.vit_mid_linear = nn.Linear(mid_hw, seq_length)

    def forward(self, mid_input: torch.Tensor,
                mid_output: torch.Tensor) -> torch.Tensor:
        x = torch.cat([mid_input, mid_output], dim=-1)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c).transpose(1, 2)        # (B, 2C, H*W)
        return self.vit_mid_linear(x).transpose(1, 2)     # (B, S, 2C)


def _same_pads(spatial, kernel: int, stride: int) -> list[int]:
    """flax's 'SAME' padding as ``F.pad``'s list (last axis first)."""
    pads = []
    for n in reversed(spatial):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _same_conv(conv: nn.Module, x: torch.Tensor, k: int) -> torch.Tensor:
    """``conv`` (kernel = stride = k) of channels-last ``x``, 'SAME'
    padded."""
    return on_channels_first(
        lambda t: conv(F.pad(t, _same_pads(t.shape[2:], k, k))), x)


class PatchEmbed3D(nn.Module):
    """A volume -> ``(B, N, dim)`` tokens: a conv of half the patch
    (stride = kernel), gelu, then a 2x2x2 stride-2 conv (1x1x1 at patch
    1), both 'SAME' padded (PatchEmbed/project, classifier.py:18-85)."""

    def __init__(self, in_channels: int, patch_size: int = 8,
                 dim: int = 512):
        super().__init__()
        self.s = max(patch_size // 2, 1)
        self.k2 = 2 if patch_size > 1 else 1
        self.proj1 = nn.Conv3d(in_channels, dim // 2, self.s, stride=self.s)
        self.proj2 = nn.Conv3d(dim // 2, dim, self.k2, stride=self.k2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(_same_conv(self.proj1, x, self.s), approximate="tanh")
        x = _same_conv(self.proj2, x, self.k2)
        return x.reshape(x.shape[0], -1, x.shape[-1])


class StridedConv(nn.Module):
    """A conv with a stride, then the rest of ``order``
    (SingleConv_modi, classifier.py:6-14): 'c' the conv (a bias only
    without 'g' or 'b'), 'g' a GroupNorm named ``gn_<position>`` (1 group
    when the channels are fewer than ``num_groups``), 'e' elu, 'r' relu,
    'l' leaky relu (0.01); other letters are skipped, as in JAX."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, order: str = "cge",
                 num_groups: int = 8, padding: int = 1, stride: int = 1):
        super().__init__()
        self.order = order
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              bias=not ("g" in order or "b" in order))
        c_pos = order.index("c")
        for i, char in enumerate(order):
            if char == "g":
                width = in_channels if i < c_pos else out_channels
                self.add_module(f"gn_{i}", GroupNorm(width, num_groups,
                                                     eps=FLAX_GN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, char in enumerate(self.order):
            if char == "c":
                x = on_channels_first(self.conv, x)
            elif char == "g":
                x = getattr(self, f"gn_{i}")(x)
            elif char == "e":
                x = F.elu(x)
            elif char == "r":
                x = F.relu(x)
            elif char == "l":
                x = F.leaky_relu(x, 0.01)
        return x


def _pool(x: torch.Tensor, window: int = 3, stride: int = 2,
          kind: str = "max") -> torch.Tensor:
    """A VALID ``kind`` pool of channels-last ``x``; a window larger than
    a spatial dim raises (torch's pools would, XLA's would give an empty
    tensor)."""
    dims = x.dim() - 2
    if any(d < window for d in x.shape[1:1 + dims]):
        raise ValueError(
            f"pyramid pool window {window} exceeds spatial dims "
            f"{tuple(x.shape[1:1 + dims])}; combiner inputs are too small")
    fn = {("max", 2): F.max_pool2d, ("max", 3): F.max_pool3d,
          ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}[kind, dims]
    return on_channels_first(lambda t: fn(t, window, stride), x)


def _pooled(n: int, pools: int) -> int:
    """A spatial extent after ``_PyramidExtract``'s stride-2 conv and
    ``pools`` VALID 3/2 pools."""
    n = (n - 1) // 2 + 1
    for _ in range(pools):
        n = (n - 3) // 2 + 1
    return n


class _PyramidExtract(nn.Module):
    """The legacy combiners' front (classifier.py:148-153): a stride-2
    and a stride-1 'cge' conv over the two concatenated (encoder,
    decoder) skip pairs, concatenated: ``(B, ..., 2 latent_dim)``."""

    def __init__(self, latent_dim: int,
                 in_channels: Sequence[int] = SKIP_CHANNELS):
        super().__init__()
        self.extract_0 = StridedConv(in_channels[0], latent_dim, 3, "cge",
                                     8, 1, stride=2)
        self.extract_1 = StridedConv(in_channels[1], latent_dim, 3, "cge",
                                     8, 1, stride=1)

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        if not len(encoders_feature) == len(decoders_feature) == 2:
            raise ValueError("the pyramid takes two encoder and two "
                             "decoder features")
        feats = [mod(torch.cat([en, de], dim=-1)) for en, de, mod in zip(
            encoders_feature, decoders_feature,
            (self.extract_0, self.extract_1))]
        return torch.cat(feats, dim=-1)


def _feature_conv(in_channels: int, out_channels: int) -> StridedConv:
    return StridedConv(in_channels, out_channels, 1, "cge", 8, 0)


class _Pyramid(nn.Module):
    """Extract, pool, then three 1x1 'cge' convs of widths ``widths``,
    each pooled, the last by average (the descriptor of
    ``CombineClassifier``, ``...Fused``, ``...2`` and ``...3``)."""

    def __init__(self, latent_dim: int, in_channels: Sequence[int],
                 widths: Sequence[int]):
        super().__init__()
        self.extract = _PyramidExtract(latent_dim, in_channels)
        ins = (2 * latent_dim, *widths[:2])
        for i, (c_in, c_out) in enumerate(zip(ins, widths), start=3):
            self.add_module(f"feature{i}_conv", _feature_conv(c_in, c_out))

    def pyramid(self, encoders_feature, decoders_feature) -> torch.Tensor:
        x = _pool(self.extract(encoders_feature, decoders_feature))
        x = _pool(self.feature3_conv(x))
        x = _pool(self.feature4_conv(x))
        return _pool(self.feature5_conv(x), kind="avg")


class CombineClassifier(_Pyramid):
    """Combine_classfier (classifier.py:144-182): the pyramid, flattened,
    -> one logit.  ``spatial`` is the first skip pair's extent."""

    def __init__(self, latent_dim: int = 16,
                 in_channels: Sequence[int] = SKIP_CHANNELS,
                 spatial: Sequence[int] = (160, 160, 96)):
        super().__init__(latent_dim, in_channels, (latent_dim,) * 3)
        voxels = math.prod(_pooled(n, 4) for n in spatial)
        self.fully_con = nn.Linear(latent_dim * voxels, 1)

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        x = self.pyramid(encoders_feature, decoders_feature)
        return self.fully_con(x.reshape(x.shape[0], -1))


class CombineClassifierFused(_Pyramid):
    """Combine_classfier_ (classifier.py:253-295): the flattened pyramid
    as one token, ``ft_tokens`` tokens of an external feature of that
    width after it, -> one logit."""

    def __init__(self, latent_dim: int = 16,
                 in_channels: Sequence[int] = SKIP_CHANNELS,
                 spatial: Sequence[int] = (160, 160, 96),
                 ft_tokens: int = 1):
        super().__init__(latent_dim, in_channels, (latent_dim,) * 3)
        voxels = math.prod(_pooled(n, 4) for n in spatial)
        self.fully_con = nn.Linear((1 + ft_tokens) * latent_dim * voxels, 1)

    def forward(self, encoders_feature, decoders_feature,
                ft_feature: torch.Tensor) -> torch.Tensor:
        x = self.pyramid(encoders_feature, decoders_feature)
        b = x.shape[0]
        combined = torch.cat([x.reshape(b, 1, -1), ft_feature], dim=1)
        return self.fully_con(combined.reshape(b, -1))


class CombineClassifier2(_Pyramid):
    """Combine_classfier_2 (classifier.py:286-325): a constant-width
    pyramid flattened into one token ``(B, 1, latent_dim * voxels)``."""

    def __init__(self, latent_dim: int = 16,
                 in_channels: Sequence[int] = SKIP_CHANNELS):
        super().__init__(latent_dim, in_channels, (latent_dim,) * 3)

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        x = self.pyramid(encoders_feature, decoders_feature)
        return x.reshape(x.shape[0], 1, -1)


class CombineClassifier3(_Pyramid):
    """Combine_classfier_3 (classifier.py:336-370): a widening pyramid
    (2, 4, 4 times ``latent_dim``) as voxel tokens ``(B, voxels,
    4 latent_dim)``."""

    def __init__(self, latent_dim: int = 128,
                 in_channels: Sequence[int] = SKIP_CHANNELS):
        super().__init__(latent_dim, in_channels,
                         (2 * latent_dim, 4 * latent_dim, 4 * latent_dim))

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        x = self.pyramid(encoders_feature, decoders_feature)
        return x.reshape(x.shape[0], -1, x.shape[-1])


# Combine_classfier_3's skeleton under the name the JAX package exports
CombinePyramid = CombineClassifier3


class CombineClassifierCross(nn.Module):
    """Combine_classfier_cross (classifier.py:186-225): the pyramid with
    -inf-padded 3/2 max pools as ``(B, latent_dim, voxels)`` condition
    tokens."""

    def __init__(self, latent_dim: int = 16,
                 in_channels: Sequence[int] = SKIP_CHANNELS):
        super().__init__()
        self.extract = _PyramidExtract(latent_dim, in_channels)
        self.feature3_conv = _feature_conv(2 * latent_dim, latent_dim)
        self.feature4_conv = _feature_conv(latent_dim, latent_dim)

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        def padded_pool(x):
            return on_channels_first(lambda t: F.max_pool3d(t, 3, 2, 1), x)

        x = padded_pool(self.extract(encoders_feature, decoders_feature))
        x = padded_pool(self.feature3_conv(x))
        x = padded_pool(self.feature4_conv(x))
        return x.reshape(x.shape[0], -1, x.shape[-1]).transpose(1, 2)


class CombineClassifierEmb(nn.Module):
    """Combine_classfier_emb (classifier.py:229-250): the extracted
    pyramid front through a 3D patch embedding -> ``(B, N, embed_dim)``."""

    def __init__(self, latent_dim: int = 16, patch_size: int = 16,
                 embed_dim: int = 512,
                 in_channels: Sequence[int] = SKIP_CHANNELS):
        super().__init__()
        self.extract = _PyramidExtract(latent_dim, in_channels)
        self.patch_embbeder = PatchEmbed3D(2 * latent_dim, patch_size,
                                           embed_dim)

    def forward(self, encoders_feature, decoders_feature) -> torch.Tensor:
        return self.patch_embbeder(self.extract(encoders_feature,
                                                decoders_feature))
