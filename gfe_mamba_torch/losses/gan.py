"""Adversarial losses over PatchGAN logits (counterpart of
``gfe_mamba_tpu/losses/gan.py``): the ``(logits, target_is_real,
for_discriminator)`` contract of MONAI's ``PatchAdversarialLoss`` with
least-squares, bce and hinge criteria.  A list of logits (multi-scale
discriminators) gives the mean of the per-entry losses."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _single_loss(logits: torch.Tensor, target_is_real: bool,
                 for_discriminator: bool, criterion: str) -> torch.Tensor:
    # the generator is always trained towards "real"
    real = target_is_real or not for_discriminator
    target = 1.0 if real else 0.0
    if criterion == "least_squares":
        return torch.mean((logits - target) ** 2)
    if criterion == "bce":
        return F.binary_cross_entropy_with_logits(
            logits, torch.full_like(logits, target))
    if criterion == "hinge":
        if not for_discriminator:
            return -torch.mean(logits)
        if target_is_real:
            return torch.mean(F.relu(1.0 - logits))
        return torch.mean(F.relu(1.0 + logits))
    raise ValueError(f"unknown criterion {criterion!r}")


def patch_adversarial_loss(logits: torch.Tensor | Sequence[torch.Tensor],
                           target_is_real: bool, for_discriminator: bool,
                           criterion: str = "least_squares") -> torch.Tensor:
    if isinstance(logits, (list, tuple)):
        return torch.stack([
            _single_loss(entry, target_is_real, for_discriminator, criterion)
            for entry in logits]).mean()
    return _single_loss(logits, target_is_real, for_discriminator, criterion)
