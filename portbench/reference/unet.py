"""The UNets of pytorch-3dunet (wolny/pytorch-3dunet, ``unet3d/model.py``
and ``buildingblocks.py``) as plain functions of a parameter dict:
``SingleConv`` by its order string, ``DoubleConv``, ``ResNetBlock``, the
encoder and decoder stacks, and the GAN-ViT generator of GFE-Mamba
(Tinysqua/GFE-Mamba), whose bottleneck folds the volume to an image for
a ViT (:mod:`portbench.reference.vit`).  Keys are the published
state_dict's (``encoders.0.basic_module.conv2.conv.weight``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import (act, conv3d, conv_transpose3d,
                                        group_norm)
from portbench.reference.vit import image_to_image_vit


def single_conv(P, pre, x, order, groups, q):
    """``SingleConv``: 'g' GroupNorm, 'c' 3x3x3 conv (padding 1, a bias
    only without a norm), 'r'/'e'/'l' activations, in ``order``."""
    for ch in order:
        if ch == "g":
            x = group_norm(x, P[f"{pre}.groupnorm.weight"],
                           P[f"{pre}.groupnorm.bias"], groups)
        elif ch == "c":
            x = conv3d(x, P[f"{pre}.conv.weight"], P.get(f"{pre}.conv.bias"),
                       q)
        else:
            x = act(x, ch)
    return x


def double_conv(P, pre, x, order, groups, q):
    x = single_conv(P, f"{pre}.SingleConv1", x, order, groups, q)
    return single_conv(P, f"{pre}.SingleConv2", x, order, groups, q)


def resnet_block(P, pre, x, order, groups, q):
    """1x1x1 shortcut where the widths differ, a SingleConv, a second
    without its activation, the sum, then the tail activation (leaky 0.1
    for 'l', elu for 'e', else relu)."""
    if f"{pre}.conv1.weight" in P:
        x = conv3d(x, P[f"{pre}.conv1.weight"], P[f"{pre}.conv1.bias"], q,
                   padding=0)
    out = single_conv(P, f"{pre}.conv2", x, order, groups, q)
    out = single_conv(P, f"{pre}.conv3",
                      out, "".join(c for c in order if c not in "rel"),
                      groups, q)
    out = out + x
    if "l" in order:
        return F.leaky_relu(out, 0.1)
    return F.elu(out) if "e" in order else F.relu(out)


def basic(P, pre, x, module, order, groups, q):
    fn = double_conv if module == "DoubleConv" else resnet_block
    return fn(P, f"{pre}.basic_module", x, order, groups, q)


def encode(P, x, levels, module, order, groups, q):
    """The encoder stack; encoder 0 does not pool.  Returns each level's
    output, top first."""
    feats = []
    for i in range(levels):
        if i:
            x = F.max_pool3d(x, 2)
        x = basic(P, f"encoders.{i}", x, module, order, groups, q)
        feats.append(x)
    return feats


def decode(P, x, skips, module, order, groups, q):
    """Decoders from the bottom up: DoubleConv joins a nearest upsample
    by concatenation, ResNetBlock a transposed conv by a sum."""
    for i, skip in enumerate(skips):
        pre = f"decoders.{i}"
        if module == "DoubleConv":
            up = F.interpolate(x, size=skip.shape[2:], mode="nearest")
            x = torch.cat([skip, up], dim=1)
        else:
            x = skip + conv_transpose3d(
                x, P[f"{pre}.upsampling.upsample.conv_transposed.weight"], q)
        x = basic(P, pre, x, module, order, groups, q)
    return x


def unet3d_logits(P, x, *, levels, order="gcr", groups=8, q):
    """pytorch-3dunet's ``UNet3D`` in train mode (logits: the final
    sigmoid runs in eval mode only), ``x (B, C, X, Y, Z)``."""
    feats = encode(P, x, levels, "DoubleConv", order, groups, q)
    x = decode(P, feats[-1], feats[-2::-1], "DoubleConv", order, groups, q)
    return conv3d(x, P["final_conv.weight"], P["final_conv.bias"], q,
                  padding=0)


def fold_3d_to_2d(x, fold):
    """``b (m1 m2) h w c -> b (h m1) (m2 w) c`` of a channels-last
    volume."""
    b, X, h, w, c = x.shape
    m2 = X // fold
    x = x.reshape(b, fold, m2, h, w, c).permute(0, 3, 1, 2, 4, 5)
    return x.reshape(b, h * fold, m2 * w, c)


def unfold_2d_to_3d(x, fold, w):
    b, H, W, c = x.shape
    h, m2 = H // fold, W // w
    x = x.reshape(b, h, fold, m2, w, c).permute(0, 2, 3, 1, 4, 5)
    return x.reshape(b, fold * m2, h, w, c)


def vit_generator(P, mri, *, levels, order, groups, fold, vit, q,
                  drop=None):
    """GFE-Mamba's ``Residual_mid_UNet3D_vit``: ``mri (B, X, Y, Z, 1)``
    channels-last -> ``(mid_input, mid_output, pet)``, the first two
    ``(B, H, W, C)`` images around the ViT, pet channels-last.  ``drop``:
    the ViT's dropout in train mode (None in eval mode)."""
    x = mri.float().permute(0, 4, 1, 2, 3)
    feats = encode(P, x, levels, "ResNetBlock", order, groups, q)
    bottom = feats[-1].permute(0, 2, 3, 4, 1)
    mid_input = fold_3d_to_2d(bottom, fold)
    mid_output = image_to_image_vit(P, "mid", mid_input, q=q, drop=drop,
                                    **vit)
    x = unfold_2d_to_3d(mid_output, fold, bottom.shape[3])
    x = decode(P, x.permute(0, 4, 1, 2, 3), feats[-2::-1], "ResNetBlock",
               order, groups, q)
    pet = conv3d(x, P["final_conv.weight"], P["final_conv.bias"], q,
                 padding=0)
    return mid_input, mid_output, pet.permute(0, 2, 3, 4, 1)
