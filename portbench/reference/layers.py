"""Functional layers of the reference models, in float32.

Every convolution and matrix product takes its operands through a
:class:`~portbench.reference.precision.Rounding` ``q``; the rest
(norms, activations, softmax, the scan) runs in float32 as written.
Volumes are channels-first ``(B, C, X, Y, Z)``, as upstream's PyTorch
code holds them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear(x, w, b=None, q=None):
    y = q.out(F.linear(q(x), q(w)))
    return y if b is None else y + b.float()


def conv3d(x, w, b=None, q=None, padding=1):
    y = q.out(F.conv3d(q(x), q(w), padding=padding))
    return y if b is None else y + b.float().reshape(1, -1, 1, 1, 1)


def conv_transpose3d(x, w, q=None):
    """ConvTranspose3d(k=3, stride 2, padding 1) to exactly 2n samples
    per axis (upstream passes the skip's size as ``output_size``)."""
    return q.out(F.conv_transpose3d(q(x), q(w), stride=2, padding=1,
                                    output_padding=1))


def einsum(spec, a, b, q):
    return q.out(torch.einsum(spec, q(a), q(b)))


def group_norm(x, w, b, groups, eps=1e-5):
    """``nn.GroupNorm``; a single group when there are fewer channels
    than groups (pytorch-3dunet's rule)."""
    c = x.shape[1]
    return F.group_norm(x, groups if c >= groups else 1, w.float(),
                        b.float(), eps)


def layer_norm(x, w, b, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def rms_norm(x, w, eps=1e-5):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def act(x, name):
    if name == "r":
        return F.relu(x)
    if name == "e":
        return F.elu(x)
    if name == "l":
        return F.leaky_relu(x, 0.01)
    raise ValueError(f"unknown activation {name!r}")


def attention(q_, k, v, heads, q, drop=None):
    """Softmax attention of ``(B, n, h*d)`` queries over ``(B, m, h*d)``
    keys and values, scaled by d^-1/2; ``drop`` (a :class:`Dropout`) on
    the attention map."""
    b, n, _ = q_.shape
    m = k.shape[1]
    d = q_.shape[-1] // heads
    qh = q_.reshape(b, n, heads, d).transpose(1, 2)
    kh = k.reshape(b, m, heads, d).transpose(1, 2)
    vh = v.reshape(b, m, heads, d).transpose(1, 2)
    logits = einsum("bhid,bhjd->bhij", qh, kh, q) / math.sqrt(d)
    attn = torch.softmax(logits, -1)
    if drop is not None:
        attn = drop(attn)
    out = einsum("bhij,bhjd->bhid", attn, vh, q)
    return out.transpose(1, 2).reshape(b, n, heads * d)


class Dropout:
    """Dropout at rate ``p`` whose keep masks come from ``generator``, one
    uniform draw of the tensor's shape per call, kept where >= p, the
    kept values scaled by 1 / (1 - p)."""

    def __init__(self, generator, p: float):
        self.generator, self.p = generator, p

    def __call__(self, x):
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)
