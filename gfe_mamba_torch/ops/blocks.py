"""Conv building blocks of the UNets (counterpart of
``gfe_mamba_tpu/ops/blocks.py``), channels-last ``(B, *spatial, C)``,
2D or 3D.

Submodule and parameter names follow the reference torch state_dict
(``encoders.0.basic_module.conv2.conv.weight``, ``...conv2.groupnorm.weight``,
``decoders.0.upsampling.upsample.conv_transposed.weight``), so the JAX
package's ``utils/torch_import.py`` maps the generator's onto the flax
trees; the segmentation blocks keep the flax names of the JAX package
(``SingleConv1``, ``batchnorm``, ``block``, ``se``, ``cSE.fc1``), which
``utils/convert.py`` carries across.

Which conv runs where is a rule on the conv's spec, fixed when the block
is built (:func:`k1_eligible`): a 3D 3x3x3 conv with padding 1 (stride 1)
whose input and output channels are multiples of 8 runs through
``ops.conv3d.conv3x3x3`` (K1 on the card; its backward K1 and K3), with
the GroupNorm right before it folded into a per-(batch, channel) affine,
the activation right after it, and a ResNetBlock's residual sum and tail
activation in its epilogue; every other conv (a C_in = 1 stem, 2D convs,
other kernel sizes or paddings, channels K1 does not take) runs through
cuDNN (``ops.conv3d.conv_nd``) with its neighbours as separate ops.  A K1
failure raises; nothing falls back.
"""

from __future__ import annotations

import torch
from torch import nn

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.ops.conv3d import (apply_act, conv3x3x3, conv_nd,
                                        deconv3x3x3_s2, deconv_nd,
                                        group_norm_stats, interpolate_to,
                                        pool_nd, resize_nearest)
from gfe_mamba_torch.utils.profiling import annotate

_ACT_NAMES = {"r": "relu", "e": "elu", "l": "leaky001", None: "none"}
_ORDER_CHARS = set("bgrlecdD")


def k1_eligible(dims: int, kernel_size: int, padding, in_channels: int,
                out_channels: int) -> bool:
    """The conv rule: whether a stride-1 conv of this spec runs through
    K1 (module docstring); the others run through cuDNN."""
    pad_one = padding == 1 or (isinstance(padding, (tuple, list))
                               and all(p == 1 for p in padding))
    return (dims == 3 and kernel_size == 3 and pad_one
            and in_channels % 8 == 0 and out_channels % 8 == 0)


def _spread(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-(batch, channel) ``(B, C)`` tensor shaped to broadcast over
    x's spatial dims, in x's dtype."""
    return t.to(x.dtype).reshape(t.shape[0], *([1] * (x.dim() - 2)),
                                 t.shape[1])


class DotConv1x1(nn.Module):
    """1x1 conv as a channel matmul; the weight keeps the torch ConvNd
    layout ``(O, I, 1, 1[, 1])``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 dims: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *(1,) * dims))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return nn.functional.linear(x, w, b)


class ConvWeights(nn.Module):
    """Parameter holder of a conv: ``weight`` ``(O, I, *k)`` and ``bias``
    only when the layer has no normalization."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool,
                 kernel_size: int = 3, dims: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *(kernel_size,) * dims))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def kernel(self, dtype) -> torch.Tensor:
        """A 3x3x3 weight in the flax layout ``(3, 3, 3, I, O)`` K1
        takes."""
        return self.weight.to(dtype).permute(2, 3, 4, 1, 0).contiguous()


class GroupNorm(nn.Module):
    """Parameters of a GroupNorm (eps 1e-5 unless given, 1 group when
    C < num_groups); ``affine`` folds it into per-(batch, channel) scale
    and shift."""

    def __init__(self, num_channels: int, num_groups: int,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.groups = num_groups if num_channels >= num_groups else 1
        if num_channels % self.groups:
            raise ValueError(
                f"channels {num_channels} not divisible by groups "
                f"{self.groups}")
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))

    def affine(self, x: torch.Tensor):
        mu, rstd = group_norm_stats(x, self.groups, eps=self.eps)
        scale = rstd * self.weight.to(rstd.dtype)
        return scale, self.bias.to(rstd.dtype) - mu * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.affine(x)
        return x * _spread(scale, x) + _spread(shift, x)


class InstanceNorm(nn.Module):
    """flax's ``GroupNorm(group_size=1)``: per-(sample, channel)
    normalisation of a channels-first map (or, with ``channels_last``, a
    channels-last one), eps 1e-6 and var = E[x^2] - E[x]^2, with a
    per-channel affine (``weight``, ``bias``).  The PatchGAN
    discriminator's and MVCSNet's instance norms."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 channels_last: bool = False):
        super().__init__()
        self.eps, self.channels_last = eps, channels_last
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channels_last:
            dims = tuple(range(1, x.dim() - 1))
            shape = (1,) * (x.dim() - 1) + (-1,)
        else:
            dims = tuple(range(2, x.dim()))
            shape = (1, -1) + (1,) * len(dims)
        mean = x.mean(dims, keepdim=True)
        var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) \
            * self.weight.reshape(shape) + self.bias.reshape(shape)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.99): in train mode the
    batch's mean and biased variance (E[x^2] - E[x]^2, at least f32)
    normalize x and move the running statistics, as a flax apply with
    ``batch_stats`` mutable does; in eval mode the running statistics
    normalize.  The running statistics are buffers, initialized to 0 and
    1 as flax's ``batch_stats``."""

    def __init__(self, num_channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def reset_running_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.to(x.dtype)) * mul.to(x.dtype)
                + self.bias.to(x.dtype))


class SingleConv(nn.Module):
    """One conv layer from an ``order`` string (``SingleConv`` of the JAX
    package): 'c' conv, 'g' GroupNorm, 'b' BatchNorm, 'r' ReLU, 'l' leaky
    ReLU (0.01), 'e' ELU, 'd' dropout, 'D' channel dropout; at most one
    'g' and one 'b'.  The conv learns a bias only without 'g' and 'b'.
    Where :func:`k1_eligible` holds, a GroupNorm right before the conv
    and an activation right after it run inside the K1 call, and when the
    conv ends the order with no activation, a ResNetBlock's residual sum
    and tail activation run there too."""

    def __init__(self, in_channels: int, out_channels: int, order: str,
                 num_groups: int = 8, kernel_size: int = 3, padding=1,
                 dropout_prob: float = 0.1, dims: int = 3):
        super().__init__()
        if "c" not in order:
            raise ValueError(f"order must hold 'c': {order!r}")
        if not set(order) <= _ORDER_CHARS:
            raise ValueError(f"unsupported layer type in {order!r}: must be "
                             f"one of {sorted(_ORDER_CHARS)}")
        if order[0] in "rle":
            raise ValueError("non-linearity cannot be the first operation")
        if order.count("g") > 1 or order.count("b") > 1:
            raise ValueError(f"at most one 'g' and one 'b': {order!r}")
        self.order, self.padding = order, padding
        self.conv_pos = order.index("c")
        self.conv = ConvWeights(in_channels, out_channels,
                                not ("g" in order or "b" in order),
                                kernel_size, dims)
        self.fused = k1_eligible(dims, kernel_size, padding, in_channels,
                                 out_channels)

        def width(ch):
            return in_channels if order.index(ch) < self.conv_pos \
                else out_channels

        if "g" in order:
            self.groupnorm = GroupNorm(width("g"), num_groups)
        if "b" in order:
            self.batchnorm = BatchNorm(width("b"))
        if "d" in order:
            self.dropout = Dropout(dropout_prob)
        if "D" in order:
            self.dropout2d = Dropout(dropout_prob,
                                     tuple(range(1, dims + 1)))

    def _fusion(self):
        """The order positions the K1 call consumes, the activation it
        applies, whether it folds the GroupNorm and whether the conv ends
        the order."""
        order, pos = self.order, self.conv_pos
        fuse_gn = pos > 0 and order[pos - 1] == "g"
        act = order[pos + 1] if pos + 1 < len(order) \
            and order[pos + 1] in "rle" else None
        consumed = {pos}
        if fuse_gn:
            consumed.add(pos - 1)
        if act:
            consumed.add(pos + 1)
        return consumed, act, fuse_gn, max(consumed) == len(order) - 1

    def forward(self, x: torch.Tensor, residual=None,
                post_act: str = "none") -> torch.Tensor:
        with annotate("gfe.conv3d"):
            return self._forward(x, residual, post_act)

    def _forward(self, x, residual, post_act):
        consumed, act, fuse_gn, conv_is_last = self._fusion() \
            if self.fused else (set(), None, False, False)
        for i, ch in enumerate(self.order):
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
            elif ch == "c":
                x = conv_nd(x, self.conv.weight, self.conv.bias,
                            self.padding)
            elif ch in "rle":
                x = apply_act(x, _ACT_NAMES[ch])
            elif ch == "g":
                x = self.groupnorm(x)
            elif ch == "b":
                x = self.batchnorm(x)
            elif ch == "d":
                x = self.dropout(x)
            else:
                x = self.dropout2d(x)
        if residual is not None:
            x = x + residual.to(x.dtype)
        return apply_act(x, post_act)


class DoubleConv(nn.Module):
    """Two SingleConvs: in the encoder the first goes to ``out_channels //
    2`` (all of them at ``upscale`` 1), never below ``in_channels``; in
    the decoder both go to ``out_channels``.  ``dropout_prob`` may be a
    pair, one per conv."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 kernel_size: int = 3, order: str = "gcr",
                 num_groups: int = 8, padding=1, upscale: int = 2,
                 dropout_prob=0.1, dims: int = 3):
        super().__init__()
        if encoder:
            conv1_out = out_channels if upscale == 1 else out_channels // 2
            conv1_out = max(conv1_out, in_channels)
        else:
            conv1_out = out_channels
        p1, p2 = (dropout_prob[0], dropout_prob[1]) \
            if isinstance(dropout_prob, (list, tuple)) \
            else (dropout_prob, dropout_prob)
        self.SingleConv1 = SingleConv(in_channels, conv1_out, order,
                                      num_groups, kernel_size, padding, p1,
                                      dims)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, order,
                                      num_groups, kernel_size, padding, p2,
                                      dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class ResNetBlock(nn.Module):
    """1x1 shortcut (when channels differ) + two SingleConvs (padding 1),
    the second with its non-linearity stripped, then sum and a tail
    non-linearity (leaky 0.1 for 'l', elu for 'e', else relu), fused into
    conv3 where K1 takes it."""

    def __init__(self, in_channels: int, out_channels: int,
                 order: str = "cge", num_groups: int = 8,
                 kernel_size: int = 3, dims: int = 3):
        super().__init__()
        if in_channels != out_channels:
            self.conv1 = DotConv1x1(in_channels, out_channels, dims=dims)
        else:
            self.conv1 = None
        self.conv2 = SingleConv(out_channels, out_channels, order, num_groups,
                                kernel_size, dims=dims)
        n_order = "".join(c for c in order if c not in "rel")
        self.conv3 = SingleConv(out_channels, out_channels, n_order,
                                num_groups, kernel_size, dims=dims)
        self.post = ("leaky01" if "l" in order
                     else "elu" if "e" in order else "relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.conv1 is None else self.conv1(x)
        out = self.conv2(residual)
        return self.conv3(out, residual=residual, post_act=self.post)


class ChannelSELayer(nn.Module):
    """Channel squeeze-and-excitation: the spatial mean through fc1 +
    relu and fc2 + sigmoid scales each channel."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(num_channels, num_channels // reduction_ratio)
        self.fc2 = nn.Linear(num_channels // reduction_ratio, num_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.mean(tuple(range(1, x.dim() - 1)))
        scale = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))
        return x * _spread(scale, x)


class SpatialSELayer(nn.Module):
    """Spatial squeeze-and-excitation: a 1x1 conv to one channel +
    sigmoid scales each voxel."""

    def __init__(self, num_channels: int, dims: int = 3):
        super().__init__()
        self.conv = DotConv1x1(num_channels, 1, dims=dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))


class ChannelSpatialSELayer(nn.Module):
    """max(cSE(x), sSE(x))."""

    def __init__(self, num_channels: int, reduction_ratio: int = 2,
                 dims: int = 3):
        super().__init__()
        self.cSE = ChannelSELayer(num_channels, reduction_ratio)
        self.sSE = SpatialSELayer(num_channels, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.cSE(x), self.sSE(x))


class ResNetBlockSE(nn.Module):
    """A ResNetBlock (``block``) followed by an SE module (``se``:
    'scse', 'cse' or 'sse', reduction ratio 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 order: str = "cge", num_groups: int = 8,
                 se_module: str = "scse", kernel_size: int = 3,
                 dims: int = 3):
        super().__init__()
        self.block = ResNetBlock(in_channels, out_channels, order, num_groups,
                                 kernel_size, dims)
        if se_module == "scse":
            self.se = ChannelSpatialSELayer(out_channels, 1, dims)
        elif se_module == "cse":
            self.se = ChannelSELayer(out_channels, 1)
        elif se_module == "sse":
            self.se = SpatialSELayer(out_channels, dims)
        else:
            raise ValueError(f"unknown se_module {se_module!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.se(self.block(x))


def make_basic(basic_module: str, in_channels: int, out_channels: int, *,
               encoder: bool, kernel_size: int = 3, order: str = "gcr",
               num_groups: int = 8, padding=1, upscale: int = 2,
               dropout_prob=0.1, dims: int = 3) -> nn.Module:
    """A basic block by name, given only the arguments it takes
    (``_make_basic``)."""
    if basic_module == "DoubleConv":
        return DoubleConv(in_channels, out_channels, encoder, kernel_size,
                          order, num_groups, padding, upscale, dropout_prob,
                          dims)
    if basic_module == "ResNetBlock":
        return ResNetBlock(in_channels, out_channels, order, num_groups,
                           kernel_size, dims)
    if basic_module == "ResNetBlockSE":
        return ResNetBlockSE(in_channels, out_channels, order, num_groups,
                             kernel_size=kernel_size, dims=dims)
    raise ValueError(f"unknown basic_module {basic_module!r}")


class Encoder(nn.Module):
    """Optional pooling (max or avg, window and stride
    ``pool_kernel_size``), then a basic block."""

    def __init__(self, in_channels: int, out_channels: int,
                 basic_module: str = "DoubleConv", conv_kernel_size: int = 3,
                 apply_pooling: bool = True, pool_kernel_size: int = 2,
                 pool_type: str = "max", order: str = "gcr",
                 num_groups: int = 8, padding=1, upscale: int = 2,
                 dropout_prob=0.1, dims: int = 3):
        super().__init__()
        if pool_type not in ("max", "avg"):
            raise ValueError(f"unknown pool_type {pool_type!r}")
        self.apply_pooling = apply_pooling
        self.pool_type, self.pool_kernel_size = pool_type, pool_kernel_size
        self.basic_module = make_basic(
            basic_module, in_channels, out_channels, encoder=True,
            kernel_size=conv_kernel_size, order=order, num_groups=num_groups,
            padding=padding, upscale=upscale, dropout_prob=dropout_prob,
            dims=dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = pool_nd(x, self.pool_type, self.pool_kernel_size)
        return self.basic_module(x)


class _TransposedConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, dims: int):
        super().__init__()
        deconv = nn.ConvTranspose3d if dims == 3 else nn.ConvTranspose2d
        self.conv_transposed = deconv(in_channels, out_channels, kernel_size,
                                      stride=stride, bias=False)


class _Upsampling(nn.Module):
    """Holds the deconv weight at ``upsampling.upsample.conv_transposed``
    (torch layout ``(I, O, *k)``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2, dims: int = 3):
        super().__init__()
        self.upsample = _TransposedConv(in_channels, out_channels,
                                        kernel_size, stride, dims)


class Decoder(nn.Module):
    """Upsample, join with the skip, then a basic block (``Decoder`` of the
    JAX package; torch needs the layer sizes up front: ``in_channels``
    are the input's, the skip has ``out_channels``).

    ``upsample='default'`` is nearest + concat for DoubleConv and deconv
    + sum for ResNetBlock(SE); 'deconv' and the interpolations concat
    otherwise; 'none' joins as is.  The deconv: at 3D, kernel 3, scale 2
    and an even z extent the exact 2n one (``deconv3x3x3_s2``), unless
    ``exact_reference_upsample``; else flax's ``ConvTranspose`` with
    padding (1, 1) (2n - 1 samples at kernel 3); either is then
    nearest-resized to the skip's shape where they differ.  Interpolation
    ('nearest', 'linear' / 'bilinear' / 'trilinear', 'cubic', 'lanczos3',
    ...) goes through ``interpolate_to``."""

    def __init__(self, in_channels: int, out_channels: int,
                 basic_module: str = "DoubleConv", conv_kernel_size: int = 3,
                 scale_factor: int = 2, order: str = "gcr",
                 num_groups: int = 8, padding=1, upsample="default",
                 dropout_prob=0.1, dims: int = 3,
                 exact_reference_upsample: bool = False):
        super().__init__()
        skip = out_channels
        concat = True
        if upsample is None or upsample == "none":
            upsample = "none"
        elif upsample == "default":
            upsample, concat = (("nearest", True)
                                if basic_module == "DoubleConv"
                                else ("deconv", False))
        self.mode, self.concat = upsample, concat
        self.scale_factor = scale_factor
        self.octant = (not exact_reference_upsample and dims == 3
                       and conv_kernel_size == 3 and scale_factor == 2)
        up_channels = in_channels
        if upsample == "deconv":
            self.upsampling = _Upsampling(in_channels, out_channels,
                                          conv_kernel_size, scale_factor,
                                          dims)
            up_channels = out_channels
        if not concat and up_channels != skip:
            raise ValueError(f"a sum join needs {skip} channels, the "
                             f"upsampled input has {up_channels}")
        self.basic_module = make_basic(
            basic_module, skip + up_channels if concat else skip,
            out_channels, encoder=False, kernel_size=conv_kernel_size,
            order=order, num_groups=num_groups, padding=padding, upscale=2,
            dropout_prob=dropout_prob, dims=dims)

    def forward(self, encoder_features: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        target = encoder_features.shape[1:-1]
        if self.mode == "deconv":
            w = self.upsampling.upsample.conv_transposed.weight
            if self.octant and x.shape[3] % 2 == 0:
                x = deconv3x3x3_s2(x, w, exact_2n=True)
            else:
                x = deconv_nd(x, w, self.scale_factor)
            x = resize_nearest(x, target)
        elif self.mode != "none":
            x = interpolate_to(x, target, self.mode)
        if self.concat:
            x = torch.cat([encoder_features, x], dim=-1)
        else:
            x = encoder_features + x
        return self.basic_module(x)


def make_encoder_stack(in_channels: int, f_maps, basic_module: str,
                       conv_kernel_size: int, conv_padding, conv_upscale: int,
                       dropout_prob, layer_order: str, num_groups: int,
                       pool_kernel_size: int, dims: int) -> nn.ModuleList:
    """``make_encoder_stack`` of the JAX package; encoder 0 does not
    pool."""
    return nn.ModuleList(
        Encoder(in_channels if i == 0 else f_maps[i - 1], f,
                basic_module=basic_module, conv_kernel_size=conv_kernel_size,
                apply_pooling=i > 0, pool_kernel_size=pool_kernel_size,
                order=layer_order,
                num_groups=num_groups, padding=conv_padding,
                upscale=conv_upscale, dropout_prob=dropout_prob, dims=dims)
        for i, f in enumerate(f_maps))


def make_decoder_stack(f_maps, basic_module: str, conv_kernel_size: int,
                       conv_padding, layer_order: str, num_groups: int,
                       upsample, dropout_prob, dims: int,
                       exact_reference_upsample: bool = False
                       ) -> nn.ModuleList:
    """``make_decoder_stack`` of the JAX package: decoder i takes level
    i's output up to level i + 1's width (levels counted from the
    bottom)."""
    rev = list(reversed(f_maps))
    return nn.ModuleList(
        Decoder(rev[i], rev[i + 1], basic_module=basic_module,
                conv_kernel_size=conv_kernel_size, order=layer_order,
                num_groups=num_groups, padding=conv_padding,
                upsample=upsample, dropout_prob=dropout_prob, dims=dims,
                exact_reference_upsample=exact_reference_upsample)
        for i in range(len(rev) - 1))
