"""Training pieces of the references: the losses and Adam, written out.

``bce_dice``: pytorch-3dunet's BCEDiceLoss (alpha = beta = 1): binary
cross-entropy on the logits plus one minus the mean per-channel Dice of
their sigmoid, Dice = 2 sum(p t) / max(sum(p^2) + sum(t^2), 1e-6), over
channels-first tensors.

``Adam``: Kingma and Ba's update with bias correction, as
``torch.optim.Adam`` and optax's ``adam`` make it:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_dice(logits, target):
    bce = F.binary_cross_entropy_with_logits(logits, target)
    p = torch.sigmoid(logits).transpose(0, 1).reshape(logits.shape[1], -1)
    t = target.transpose(0, 1).reshape(target.shape[1], -1)
    dice = 2 * (p * t).sum(-1) / torch.clamp(
        (p * p).sum(-1) + (t * t).sum(-1), min=1e-6)
    return bce + 1.0 - dice.mean()


class Adam:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        for name, g in grads.items():
            m = self.m.get(name, torch.zeros_like(g))
            v = self.v.get(name, torch.zeros_like(g))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            self.m[name], self.v[name] = m, v
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            params[name] -= self.lr * mh / (torch.sqrt(vh) + self.eps)


def clip_each(grads: dict, max_norm: float) -> dict:
    """Each gradient scaled to a norm of at most ``max_norm``
    (GFE-Mamba's Stage-2 loop clips every parameter on its own)."""
    out = {}
    for name, g in grads.items():
        norm = torch.linalg.vector_norm(g)
        out[name] = g * torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
    return out


def clip_global(grads: dict, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: unchanged while the norm of all
    gradients together is under ``max_norm``, else scaled to it."""
    norm = torch.sqrt(sum(torch.linalg.vector_norm(g) ** 2
                          for g in grads.values()))
    if norm < max_norm:
        return dict(grads)
    return {k: g / norm * max_norm for k, g in grads.items()}
