"""The image-to-image ViT of GFE-Mamba's generator bottleneck
(vit-pytorch's ViT with a token-mixing un-embedding), channels-last
images ``(B, H, W, C)``: patchify, LayerNorm + Linear + LayerNorm, CLS
and positions, pre-norm attention / GELU(tanh) feed-forward blocks and a
final LayerNorm, then LayerNorm, a Linear over the n + 1 tokens to n, a
Linear back to the patch width, LayerNorm and un-patchify.  LayerNorm eps
1e-6."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import attention, layer_norm, linear


def image_to_image_vit(P, pre, img, *, patch, heads, depth, q, drop=None):
    """``drop`` (train mode): a :class:`~portbench.reference.layers.Dropout`
    for the embeddings, each attention map, each attention output and
    both feed-forward layers, in that order."""
    def d(x):
        return x if drop is None else drop(x)

    b, H, W, c = img.shape
    h, w = H // patch, W // patch
    x = img.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h * w, patch * patch * c)
    e = f"{pre}.to_patch_embedding"
    x = layer_norm(x, P[f"{e}.1.weight"], P[f"{e}.1.bias"])
    x = linear(x, P[f"{e}.2.weight"], P[f"{e}.2.bias"], q)
    x = layer_norm(x, P[f"{e}.3.weight"], P[f"{e}.3.bias"])
    cls = P[f"{pre}.cls_token"].float().expand(b, -1, -1)
    x = d(torch.cat([cls, x], dim=1) + P[f"{pre}.pos_embedding"].float())
    for i in range(depth):
        a = f"{pre}.transformer.layers.{i}.0"
        y = layer_norm(x, P[f"{a}.norm.weight"], P[f"{a}.norm.bias"])
        qkv = linear(y, P[f"{a}.to_qkv.weight"], None, q)
        qh, k, v = qkv.chunk(3, dim=-1)
        y = attention(qh, k, v, heads, q, drop)
        x = d(linear(y, P[f"{a}.to_out.0.weight"], P[f"{a}.to_out.0.bias"],
                     q)) + x
        f = f"{pre}.transformer.layers.{i}.1.net"
        y = layer_norm(x, P[f"{f}.0.weight"], P[f"{f}.0.bias"])
        y = d(F.gelu(linear(y, P[f"{f}.1.weight"], P[f"{f}.1.bias"], q),
                     approximate="tanh"))
        x = d(linear(y, P[f"{f}.4.weight"], P[f"{f}.4.bias"], q)) + x
    x = layer_norm(x, P[f"{pre}.transformer.norm.weight"],
                   P[f"{pre}.transformer.norm.bias"])
    u = f"{pre}.from_patch_embedding"
    x = layer_norm(x, P[f"{u}.0.weight"], P[f"{u}.0.bias"])
    x = linear(x.transpose(1, 2), P[f"{u}.2.weight"], P[f"{u}.2.bias"],
               q).transpose(1, 2)
    x = linear(x, P[f"{u}.4.weight"], P[f"{u}.4.bias"], q)
    x = layer_norm(x, P[f"{u}.5.weight"], P[f"{u}.5.bias"])
    x = x.reshape(b, h, w, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * patch, w * patch, c)
