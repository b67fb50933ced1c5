"""The GAN-ViT generator (counterpart of ``UNet(mid='vit')`` in
``gfe_mamba_tpu/models/unet3d.py``), channels-last volumes.

input (B,160,160,96,1) -> enc1 (no pool, 64ch) -> enc2 (pool, 128ch)
-> enc3 (pool, 256ch) = (B,40,40,24,256) -> depth-fold to (B,320,120,256)
-> image-to-image ViT -> unfold -> two decoders (2n deconv + sum join)
-> final 1x1x1 conv with bias, no sigmoid -> PET (B,160,160,96,1).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gfe_mamba_torch.models.vit import ImageToImageViT
from gfe_mamba_torch.ops.blocks import Decoder, DotConv1x1, Encoder


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


class ResidualMidUNet3DViT(nn.Module):
    """Residual UNet with a depth-fold ViT bottleneck; ``forward(x,
    output_vit_mid=True)`` returns ``(mid_input, mid_output, pet)``.

    Unlike flax, torch sizes its layers at construction, so the volume
    size ``img_size`` is an argument: it fixes the ViT's patch count."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 f_maps: Sequence[int] = (64, 128, 256),
                 layer_order: str = "gcr", num_groups: int = 8,
                 img_size: Sequence[int] = (160, 160, 96),
                 fold_factor: int = 8, vit_patch_size: int = 40,
                 vit_dim: int = 512, vit_depth: int = 4, vit_heads: int = 6,
                 vit_mlp_dim: int = 2048, vit_dropout: float = 0.1,
                 vit_emb_dropout: float = 0.1):
        super().__init__()
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
        self.encoders = nn.ModuleList(
            Encoder(in_channels if i == 0 else f_maps[i - 1], f, i > 0,
                    layer_order, num_groups)
            for i, f in enumerate(f_maps))
        rev = list(reversed(f_maps))
        self.decoders = nn.ModuleList(
            Decoder(rev[i], rev[i + 1], layer_order, num_groups)
            for i in range(len(rev) - 1))
        self.mid = ImageToImageViT(
            self.mid_size, f_maps[-1],
            patch_size=vit_patch_size, dim=vit_dim, depth=vit_depth,
            heads=vit_heads, mlp_dim=vit_mlp_dim, dropout=vit_dropout,
            emb_dropout=vit_emb_dropout)
        self.final_conv = DotConv1x1(f_maps[0], out_channels)

    def forward(self, x: torch.Tensor, output_vit_mid: bool = False):
        features = []
        for encoder in self.encoders:
            x = encoder(x)
            features.insert(0, x)
        mid_input = fold_3d_to_2d(x, self.fold_factor)
        mid_output = self.mid(mid_input)
        x = unfold_2d_to_3d(mid_output, self.fold_factor, w=x.shape[3])
        for decoder, skip in zip(self.decoders, features[1:]):
            x = decoder(skip, x)
        x = self.final_conv(x)
        if output_vit_mid:
            return mid_input, mid_output, x
        return x
