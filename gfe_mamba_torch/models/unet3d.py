"""The UNet zoo (counterpart of ``gfe_mamba_tpu/models/unet3d.py``),
channels-last volumes: the generic :class:`UNet` behind the segmentation
families ``UNet3D``, ``ResidualUNet3D``, ``ResidualUNetSE3D``, ``UNet2D``,
``ResidualUNet2D`` and ``ResidualMidUNet3D``, :func:`get_model` over
both name sets, and the GAN-ViT generator (``UNet(mid='vit')`` there):

input (B,160,160,96,1) -> enc1 (no pool, 64ch) -> enc2 (pool, 128ch)
-> enc3 (pool, 256ch) = (B,40,40,24,256) -> depth-fold to (B,320,120,256)
-> image-to-image ViT -> unfold -> two decoders (2n deconv + sum join)
-> final 1x1x1 conv with bias, no sigmoid -> PET (B,160,160,96,1).

``remat=True`` recomputes each encoder and decoder block in the backward
pass instead of keeping its activations (``torch.utils.checkpoint``, as
``nn.remat`` in the JAX model).  ``remat_call`` hands the recomputation
the parameter tensors the forward saw (``functional_call`` swaps the
trainers' compute-dtype copies in only for the forward).  The blocks it
wraps draw no dropout; a block that holds a ``Dropout`` is refused,
since its recomputation would draw new masks from the generator.
"""

from __future__ import annotations

import inspect
from typing import Any, Sequence

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from gfe_mamba_torch.models.dropout import Dropout
from gfe_mamba_torch.models.vit import ImageToImageViT
from gfe_mamba_torch.ops.blocks import (DotConv1x1, make_decoder_stack,
                                        make_encoder_stack)


def fold_3d_to_2d(x: torch.Tensor, fold: int) -> torch.Tensor:
    """``b (m1 m2) h w c -> b (h m1) (m2 w) c`` with m1 = ``fold``."""
    b, X, h, w, c = x.shape
    m2 = X // fold
    x = x.reshape(b, fold, m2, h, w, c).permute(0, 3, 1, 2, 4, 5)
    return x.reshape(b, h * fold, m2 * w, c)


def unfold_2d_to_3d(x: torch.Tensor, fold: int, w: int) -> torch.Tensor:
    """Inverse of :func:`fold_3d_to_2d`:
    ``b (h m1) (m2 w) c -> b (m1 m2) h w c``."""
    b, H, W, c = x.shape
    h, m2 = H // fold, W // w
    x = x.reshape(b, h, fold, m2, w, c).permute(0, 2, 3, 1, 4, 5)
    return x.reshape(b, fold * m2, h, w, c)


def remat_call(block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """``block(*args)``, its activations recomputed in the backward pass
    (see the module docstring); a plain call when no gradient is taken."""
    if not torch.is_grad_enabled():
        return block(*args)
    if any(isinstance(mod, Dropout) for mod in block.modules()):
        raise ValueError("remat_call: a block that draws dropout would "
                         "draw new masks when it is recomputed")
    names, tensors = zip(*block.named_parameters())

    def run(n_args: int, *inputs):
        params = dict(zip(names, inputs[n_args:]))
        return functional_call(block, params, inputs[:n_args])

    return checkpoint(run, len(args), *args, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


def _final_activation(x: torch.Tensor, final_sigmoid: bool):
    return torch.sigmoid(x) if final_sigmoid else torch.softmax(x, dim=-1)


class UNet(nn.Module):
    """Encoder/decoder UNet (``UNet`` of the JAX package with ``mid``
    'none' or 'features', which compute the same thing): ``f_maps``
    levels of ``basic_module`` blocks, decoders from the bottom up, a
    final 1x1 conv with bias, and in eval mode only (``not
    self.training``) a final sigmoid (``final_sigmoid``) or softmax over
    the channels when ``is_segmentation``.  ``forward(x,
    output_mid=True)`` returns ``(skips, decoder outputs, out)``, both
    lists from the top level down.  ``remat`` recomputes each encoder and
    decoder block in the backward pass (:func:`remat_call`)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 basic_module: str = "DoubleConv",
                 f_maps: Sequence[int] = (64, 128, 256, 512),
                 layer_order: str = "gcr", num_groups: int = 8,
                 is_segmentation: bool = True, final_sigmoid: bool = True,
                 conv_kernel_size: int = 3, pool_kernel_size: int = 2,
                 conv_padding=1, conv_upscale: int = 2,
                 upsample="default", dropout_prob=0.1, dims: int = 3,
                 exact_reference_upsample: bool = False,
                 remat: bool = False, mid: str = "none"):
        super().__init__()
        if len(f_maps) < 2:
            raise ValueError("Required at least 2 levels in the U-Net")
        if mid not in ("none", "features"):
            raise ValueError(f"mid {mid!r}: the ViT bottleneck is "
                             f"ResidualMidUNet3DViT")
        self.is_segmentation, self.final_sigmoid = is_segmentation, \
            final_sigmoid
        self.remat = remat
        self.encoders = make_encoder_stack(
            in_channels, f_maps, basic_module, conv_kernel_size,
            conv_padding, conv_upscale, dropout_prob, layer_order,
            num_groups, pool_kernel_size, dims)
        self.decoders = make_decoder_stack(
            f_maps, basic_module, conv_kernel_size, conv_padding,
            layer_order, num_groups, upsample, dropout_prob, dims,
            exact_reference_upsample)
        self.final_conv = DotConv1x1(f_maps[0], out_channels, dims=dims)

    def forward(self, x: torch.Tensor, output_mid: bool = False):
        call = remat_call if self.remat else (lambda block, *a: block(*a))
        features = []
        for encoder in self.encoders:
            x = call(encoder, x)
            features.insert(0, x)
        skips = features[1:]
        decoded = []
        for decoder, skip in zip(self.decoders, skips):
            x = call(decoder, skip, x)
            decoded.append(x)
        x = self.final_conv(x)
        if not self.training and self.is_segmentation:
            x = _final_activation(x, self.final_sigmoid)
        if output_mid:
            return skips[::-1], decoded[::-1], x
        return x


class ResidualMidUNet3DViT(nn.Module):
    """Residual UNet with a depth-fold ViT bottleneck; ``forward(x,
    output_vit_mid=True)`` returns ``(mid_input, mid_output, pet)``.

    Unlike flax, torch sizes its layers at construction, so the volume
    size ``img_size`` is an argument: it fixes the ViT's patch count.
    ``remat`` recomputes the encoder and decoder blocks in the backward
    pass (:func:`remat_call`).  ``is_segmentation`` (off by default, as
    the generator runs; :func:`get_model` turns it on, JAX's default)
    adds the final sigmoid or softmax in eval mode."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 f_maps: Sequence[int] = (64, 128, 256),
                 layer_order: str = "gcr", num_groups: int = 8,
                 img_size: Sequence[int] = (160, 160, 96),
                 fold_factor: int = 8, vit_patch_size: int = 40,
                 vit_dim: int = 512, vit_depth: int = 4, vit_heads: int = 6,
                 vit_mlp_dim: int = 2048, vit_dropout: float = 0.1,
                 vit_emb_dropout: float = 0.1, remat: bool = False,
                 is_segmentation: bool = False, final_sigmoid: bool = True):
        super().__init__()
        self.remat = remat
        self.is_segmentation, self.final_sigmoid = is_segmentation, \
            final_sigmoid
        if len(f_maps) < 2:
            raise ValueError("Required at least 2 levels in the U-Net")
        down = 2 ** (len(f_maps) - 1)
        if any(s % down for s in img_size):
            raise ValueError(f"img_size {tuple(img_size)} must be divisible "
                             f"by {down}")
        bx, by, bz = (s // down for s in img_size)
        if bx % fold_factor:
            raise ValueError(f"bottleneck x extent {bx} must be divisible by "
                             f"fold_factor {fold_factor}")
        self.img_size = tuple(img_size)
        self.fold_factor = fold_factor
        # (H, W) of the folded bottleneck image the ViT sees
        self.mid_size = (by * fold_factor, (bx // fold_factor) * bz)
        self.encoders = make_encoder_stack(
            in_channels, f_maps, "ResNetBlock", 3, 1, 2, 0.1, layer_order,
            num_groups, 2, 3)
        self.decoders = make_decoder_stack(
            f_maps, "ResNetBlock", 3, 1, layer_order, num_groups, "default",
            0.1, 3)
        self.mid = ImageToImageViT(
            self.mid_size, f_maps[-1],
            patch_size=vit_patch_size, dim=vit_dim, depth=vit_depth,
            heads=vit_heads, mlp_dim=vit_mlp_dim, dropout=vit_dropout,
            emb_dropout=vit_emb_dropout)
        self.final_conv = DotConv1x1(f_maps[0], out_channels)

    def forward(self, x: torch.Tensor, output_vit_mid: bool = False):
        call = remat_call if self.remat else (lambda block, *a: block(*a))
        features = []
        for encoder in self.encoders:
            x = call(encoder, x)
            features.insert(0, x)
        mid_input = fold_3d_to_2d(x, self.fold_factor)
        mid_output = self.mid(mid_input)
        x = unfold_2d_to_3d(mid_output, self.fold_factor, w=x.shape[3])
        for decoder, skip in zip(self.decoders, features[1:]):
            x = call(decoder, skip, x)
        x = self.final_conv(x)
        if not self.training and self.is_segmentation:
            x = _final_activation(x, self.final_sigmoid)
        if output_vit_mid:
            return mid_input, mid_output, x
        return x


def number_of_features_per_level(init_channels: int,
                                 num_levels: int) -> list[int]:
    """[c, 2c, 4c, ...]."""
    return [init_channels * 2 ** k for k in range(num_levels)]


def _family(basic_module: str, dims: int, num_levels: int):
    """A factory of the zoo (``UNet3D`` and its siblings of the JAX
    package): an int ``f_maps`` grows to ``num_levels`` levels; keys
    :class:`UNet` does not take are dropped, as JAX's ``_unet_kwargs``
    drops them."""

    def factory(in_channels: int = 1, out_channels: int = 1,
                final_sigmoid: bool = True, f_maps=64,
                layer_order: str = "gcr", num_groups: int = 8,
                num_levels: int = num_levels, is_segmentation: bool = True,
                **kwargs: Any) -> UNet:
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        return UNet(in_channels, out_channels, basic_module=basic_module,
                    f_maps=tuple(f_maps), layer_order=layer_order,
                    num_groups=num_groups, is_segmentation=is_segmentation,
                    final_sigmoid=final_sigmoid, dims=dims,
                    **_known(UNet, kwargs, ("basic_module", "dims", "mid")))
    return factory


def _known(cls, kwargs: dict, fixed=()) -> dict:
    names = set(inspect.signature(cls).parameters) - set(fixed)
    return {k: v for k, v in kwargs.items() if k in names}


UNet3D = _family("DoubleConv", 3, 4)
ResidualUNet3D = _family("ResNetBlock", 3, 5)
ResidualUNetSE3D = _family("ResNetBlockSE", 3, 5)
UNet2D = _family("DoubleConv", 2, 4)
ResidualUNet2D = _family("ResNetBlock", 2, 5)


def ResidualMidUNet3D(in_channels: int = 1, out_channels: int = 1,
                      final_sigmoid: bool = True,
                      f_maps: Sequence[int] = (64, 128, 256, 512),
                      layer_order: str = "gcr", num_groups: int = 8,
                      is_segmentation: bool = True, **kwargs: Any) -> UNet:
    """``Residual_mid_UNet3D``: a ResNetBlock UNet whose
    ``forward(x, output_mid=True)`` hands out its skip and decoder
    features."""
    return UNet(in_channels, out_channels, basic_module="ResNetBlock",
                f_maps=tuple(f_maps), layer_order=layer_order,
                num_groups=num_groups, is_segmentation=is_segmentation,
                final_sigmoid=final_sigmoid, dims=3, mid="features",
                **_known(UNet, kwargs, ("basic_module", "dims", "mid")))


def _vit_generator(in_channels: int = 1, out_channels: int = 1,
                   final_sigmoid: bool = True, is_segmentation: bool = True,
                   **kwargs: Any) -> ResidualMidUNet3DViT:
    """``ResidualMidUNet3DViT`` with JAX's defaults of the two flags."""
    return ResidualMidUNet3DViT(
        in_channels, out_channels, is_segmentation=is_segmentation,
        final_sigmoid=final_sigmoid,
        **_known(ResidualMidUNet3DViT, kwargs,
                 ("is_segmentation", "final_sigmoid")))


MODEL_ZOO = {
    "UNet3D": UNet3D,
    "ResidualUNet3D": ResidualUNet3D,
    "ResidualUNetSE3D": ResidualUNetSE3D,
    "UNet2D": UNet2D,
    "ResidualUNet2D": ResidualUNet2D,
    "Residual_mid_UNet3D": ResidualMidUNet3D,
    "ResidualMidUNet3D": ResidualMidUNet3D,
    "Residual_mid_UNet3D_vit": _vit_generator,
    "ResidualMidUNet3DViT": _vit_generator,
}


def get_model(model_config: dict, *, seed: int = 0,
              law: str = "flax") -> nn.Module:
    """The model ``model_config["name"]`` names (the reference's torch
    class names or the JAX package's), built from the rest of the config,
    on the CPU, its weights drawn from ``seed`` under ``law``
    (``utils/initializers.py``; flax's, as JAX's ``init`` draws them) and
    in eval mode.  The ViT generator's volume size is its
    ``img_size`` key."""
    from gfe_mamba_torch.utils.initializers import init_weights

    cfg = dict(model_config)
    name = cfg.pop("name")
    try:
        factory = MODEL_ZOO[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODEL_ZOO)}") from None
    with torch.device("meta"):
        model = factory(**cfg)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed), law)
    return model.eval()
