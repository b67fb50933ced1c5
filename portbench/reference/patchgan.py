"""The PatchGAN discriminator of GFE-Mamba's Stage 1 (MONAI's
``PatchDiscriminator`` as the reference trains it), 3D, over a
parameter dict: a stride-2 4x4x4 conv with LeakyReLU(0.2), then
``layers - 1`` stride-2 convs doubling the channels with instance norm
and LeakyReLU(0.2), a stride-1 conv doubling them again with the same,
and a stride-1 conv to the patch logits.  Each conv pads 1 on every side
(more on the high side where a volume is smaller than the kernel).
Instance norm: per sample and channel, var = E[x^2] - E[x]^2, eps 1e-6,
with a per-channel scale and shift.  Channels-last volumes in, the
features (logits last) out channels-last."""

from __future__ import annotations

import torch.nn.functional as F


def _pad(x, k):
    pads = []
    for n in reversed(x.shape[2:]):
        pads += [1, max(1, k - n - 1)]
    return F.pad(x, pads)


def _conv(P, name, x, q, stride):
    w = P[f"{name}.weight"]
    y = q.out(F.conv3d(q(_pad(x, w.shape[-1])), q(w), stride=stride))
    b = P.get(f"{name}.bias")
    return y if b is None else y + b.float().reshape(1, -1, 1, 1, 1)


def _instance_norm(P, name, x, eps=1e-6):
    mean = x.mean((2, 3, 4), keepdim=True)
    var = ((x * x).mean((2, 3, 4), keepdim=True) - mean * mean).clamp(min=0)
    shape = (1, -1, 1, 1, 1)
    return (x - mean) * (var + eps).rsqrt() \
        * P[f"{name}.weight"].float().reshape(shape) \
        + P[f"{name}.bias"].float().reshape(shape)


def discriminator(P, x, layers, q):
    x = x.float().permute(0, 4, 1, 2, 3)
    feats = [F.leaky_relu(_conv(P, "conv_0", x, q, 2), 0.2)]
    for i in range(1, layers):
        y = _instance_norm(P, f"norm_{i}", _conv(P, f"conv_{i}", feats[-1],
                                                 q, 2))
        feats.append(F.leaky_relu(y, 0.2))
    y = _instance_norm(P, "norm_pre", _conv(P, "conv_pre", feats[-1], q, 1))
    feats.append(F.leaky_relu(y, 0.2))
    feats.append(_conv(P, "conv_out", feats[-1], q, 1))
    return [f.permute(0, 2, 3, 4, 1) for f in feats]
