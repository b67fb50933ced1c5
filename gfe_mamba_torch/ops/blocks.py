"""Conv building blocks of the generator (counterpart of
``gfe_mamba_tpu/ops/blocks.py``), channels-last ``(B, X, Y, Z, C)``.

Submodule and parameter names follow the reference torch state_dict
(``encoders.0.basic_module.conv2.conv.weight``, ``...conv2.groupnorm.weight``,
``decoders.0.upsampling.upsample.conv_transposed.weight``), so the JAX
package's ``utils/torch_import.py`` maps them onto the flax trees.  Every
3x3x3 conv runs through ``ops.conv3d.conv3x3x3`` (K1 on the card) with the
GroupNorm that precedes it folded into a per-(batch, channel) affine.
"""

from __future__ import annotations

import torch
from torch import nn

from gfe_mamba_torch.ops.conv3d import (apply_act, conv3x3x3, deconv3x3x3_s2,
                                        group_norm_stats, max_pool2,
                                        resize_nearest)

_ACT_NAMES = {"r": "relu", "e": "elu", "l": "leaky001", None: "none"}


class DotConv1x1(nn.Module):
    """1x1x1 conv as a channel matmul; the weight keeps the torch Conv3d
    layout ``(O, I, 1, 1, 1)``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return nn.functional.linear(x, w, b)


class Conv3x3x3(nn.Module):
    """Parameter holder of a 3x3x3 conv: ``weight`` ``(O, I, 3, 3, 3)``
    and ``bias`` only when the layer has no normalization."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def kernel(self, dtype) -> torch.Tensor:
        """The weight in the flax layout ``(3, 3, 3, I, O)`` K1 takes."""
        return self.weight.to(dtype).permute(2, 3, 4, 1, 0).contiguous()


class GroupNorm(nn.Module):
    """Parameters of a GroupNorm (eps 1e-5, 1 group when C < num_groups);
    ``affine`` folds it into per-(batch, channel) scale and shift."""

    def __init__(self, num_channels: int, num_groups: int):
        super().__init__()
        self.groups = num_groups if num_channels >= num_groups else 1
        if num_channels % self.groups:
            raise ValueError(
                f"channels {num_channels} not divisible by groups "
                f"{self.groups}")
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))

    def affine(self, x: torch.Tensor):
        mu, rstd = group_norm_stats(x, self.groups, eps=1e-5)
        scale = rstd * self.weight.float()
        return scale, self.bias.float() - mu * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.affine(x)
        return (x * scale.to(x.dtype)[:, None, None, None, :]
                + shift.to(x.dtype)[:, None, None, None, :])


class SingleConv(nn.Module):
    """One conv layer from a ``gcrle`` order string (``SingleConv`` with
    ``_packed_forward``'s fusion): a GroupNorm right before the conv and an
    activation right after it run inside the conv call; when the conv ends
    the order and carries no activation, a ResNetBlock's residual sum and
    tail activation run there too."""

    def __init__(self, in_channels: int, out_channels: int, order: str,
                 num_groups: int = 8):
        super().__init__()
        if "c" not in order or not set(order) <= set("gcrle"):
            raise ValueError(
                f"order must hold 'c' and only 'gcrle': {order!r}")
        if order[0] in "rle":
            raise ValueError("non-linearity cannot be the first operation")
        self.order = order
        self.conv_pos = order.index("c")
        self.conv = Conv3x3x3(in_channels, out_channels, bias="g" not in order)
        if "g" in order:
            gn_ch = in_channels if order.index("g") < self.conv_pos \
                else out_channels
            self.groupnorm = GroupNorm(gn_ch, num_groups)

    def forward(self, x: torch.Tensor, residual=None,
                post_act: str = "none") -> torch.Tensor:
        order, pos = self.order, self.conv_pos
        fuse_gn = pos > 0 and order[pos - 1] == "g"
        act = order[pos + 1] if pos + 1 < len(order) \
            and order[pos + 1] in "rle" else None
        consumed = {pos}
        if fuse_gn:
            consumed.add(pos - 1)
        if act:
            consumed.add(pos + 1)
        conv_is_last = max(consumed) == len(order) - 1
        for i, ch in enumerate(order):
            if i in consumed:
                if ch != "c":
                    continue
                scale = shift = None
                if fuse_gn:
                    scale, shift = self.groupnorm.affine(x)
                kres = residual if (conv_is_last and act is None) else None
                bias = None if self.conv.bias is None \
                    else self.conv.bias.to(x.dtype)
                x = conv3x3x3(x, self.conv.kernel(x.dtype), bias, scale,
                              shift, kres, _ACT_NAMES[act],
                              post_act if kres is not None else "none")
                if kres is not None:
                    residual, post_act = None, "none"
            elif ch in "rle":
                x = apply_act(x, _ACT_NAMES[ch])
            else:
                x = self.groupnorm(x)
        if residual is not None:
            x = x + residual.to(x.dtype)
        return apply_act(x, post_act)


class ResNetBlock(nn.Module):
    """1x1 shortcut (when channels differ) + two SingleConvs, the second
    with its non-linearity stripped, then sum and a tail non-linearity
    (leaky 0.1 for 'l', elu for 'e', else relu), fused into conv3."""

    def __init__(self, in_channels: int, out_channels: int,
                 order: str = "cge", num_groups: int = 8):
        super().__init__()
        if in_channels != out_channels:
            self.conv1 = DotConv1x1(in_channels, out_channels)
        else:
            self.conv1 = None
        self.conv2 = SingleConv(out_channels, out_channels, order, num_groups)
        n_order = "".join(c for c in order if c not in "rel")
        self.conv3 = SingleConv(out_channels, out_channels, n_order,
                                num_groups)
        self.post = ("leaky01" if "l" in order
                     else "elu" if "e" in order else "relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv1 is None else self.conv1(x)
        out = self.conv2(residual)
        return self.conv3(out, residual=residual, post_act=self.post)


class Encoder(nn.Module):
    """Optional 2x2x2 max pool, then a ResNetBlock."""

    def __init__(self, in_channels: int, out_channels: int,
                 apply_pooling: bool, order: str, num_groups: int = 8):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.basic_module = ResNetBlock(in_channels, out_channels, order,
                                        num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = max_pool2(x)
        return self.basic_module(x)


class _TransposedConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_transposed = nn.ConvTranspose3d(
            in_channels, out_channels, 3, stride=2, padding=1, bias=False)


class _Upsampling(nn.Module):
    """Holds the deconv weight at ``upsampling.upsample.conv_transposed``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample = _TransposedConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor, exact_2n: bool = True) -> torch.Tensor:
        return deconv3x3x3_s2(x, self.upsample.conv_transposed.weight,
                              exact_2n)


class Decoder(nn.Module):
    """Stride-2 transposed conv, sum join with the skip, then a
    ResNetBlock.  As in the JAX decoder (``ops/blocks.py:711-741``): an
    even z extent takes the 2n deconv, an odd one the 2n-1 deconv, and the
    result is nearest-resized to the skip's shape where they differ."""

    def __init__(self, in_channels: int, out_channels: int, order: str,
                 num_groups: int = 8):
        super().__init__()
        self.upsampling = _Upsampling(in_channels, out_channels)
        self.basic_module = ResNetBlock(out_channels, out_channels, order,
                                        num_groups)

    def forward(self, encoder_features: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        x = self.upsampling(x, exact_2n=x.shape[3] % 2 == 0)
        x = resize_nearest(x, encoder_features.shape[1:4])
        return self.basic_module(encoder_features + x)
