"""Segmentation losses (counterpart of
``gfe_mamba_tpu/segmentation/losses.py``, reference
pytorch3dunet/unet3d/losses.py), in torch.

``get_loss_criterion(config)`` over: DiceLoss, GeneralizedDiceLoss,
BCEDiceLoss, BCEWithLogitsLoss, CrossEntropyLoss,
WeightedCrossEntropyLoss, PixelWiseCrossEntropyLoss, WeightedSmoothL1Loss,
MSELoss, SmoothL1Loss, L1Loss, with the ``ignore_index`` masking and
``skip_last_target`` wrappers.

Channels-last: inputs ``(B, *spatial, C)``; targets one-hot ``(B,
*spatial, C)`` or, for the cross-entropy losses, integer label maps
``(B, *spatial)``.  A label that indexes a class weight is taken as JAX
indexes: a negative label counts from the end, then out-of-range labels
clamp to the nearest class.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F


def flatten_per_channel(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> (C, B * prod(spatial))."""
    return x.reshape(-1, x.shape[-1]).T


def compute_per_channel_dice(pred, target, epsilon: float = 1e-6,
                             weight=None) -> torch.Tensor:
    """Per-channel Dice over the batch."""
    p = flatten_per_channel(pred)
    t = flatten_per_channel(target).float()
    intersect = (p * t).sum(-1)
    if weight is not None:
        intersect = weight * intersect
    denom = (p * p).sum(-1) + (t * t).sum(-1)
    return 2 * intersect / torch.clamp(denom, min=epsilon)


def _normalize(pred, normalization: str):
    if normalization == "sigmoid":
        return torch.sigmoid(pred)
    if normalization == "softmax":
        return torch.softmax(pred, dim=-1)
    return pred


def dice_loss(pred, target, *, normalization: str = "sigmoid",
              weight=None) -> torch.Tensor:
    pred = _normalize(pred, normalization)
    return 1.0 - compute_per_channel_dice(pred, target, weight=weight).mean()


def generalized_dice_loss(pred, target, *, normalization: str = "sigmoid",
                          epsilon: float = 1e-6) -> torch.Tensor:
    """GDL: class weights 1 / (sum t)^2, not differentiated; a single
    channel counts as foreground and background."""
    pred = _normalize(pred, normalization)
    p = flatten_per_channel(pred)
    t = flatten_per_channel(target).float()
    if p.shape[0] == 1:
        p = torch.cat([p, 1 - p], dim=0)
        t = torch.cat([t, 1 - t], dim=0)
    w = (1.0 / torch.clamp(t.sum(-1) ** 2, min=epsilon)).detach()
    intersect = (p * t).sum(-1) * w
    denom = (p.sum(-1) + t.sum(-1)) * w
    return 1.0 - 2.0 * intersect.sum() / torch.clamp(denom.sum(), min=epsilon)


def bce_with_logits(pred, target) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(pred, target.float())


def bce_dice_loss(pred, target, *, alpha: float = 1.0,
                  beta: float = 1.0) -> torch.Tensor:
    return alpha * bce_with_logits(pred, target) \
        + beta * dice_loss(pred, target)


def _jax_index(labels: torch.Tensor, n: int) -> torch.Tensor:
    """Labels as JAX gathers with them from an axis of ``n``: negative
    ones from the end, then clamped into range."""
    labels = labels.long()
    return torch.clamp(torch.where(labels < 0, labels + n, labels), 0, n - 1)


def cross_entropy_loss(pred, target, weight=None,
                       ignore_index: int | None = None) -> torch.Tensor:
    """pred ``(B, *s, C)`` logits; target ``(B, *s)`` integer labels."""
    c = pred.shape[-1]
    logp = torch.log_softmax(pred, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(
        target.long(), 0, c - 1)[..., None]).squeeze(-1)
    if weight is not None:
        nll = nll * weight[_jax_index(target, c)]
    if ignore_index is not None:
        mask = (target != ignore_index).float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def weighted_cross_entropy_loss(pred, target,
                                ignore_index: int | None = None):
    """Cross entropy with inverse-frequency class weights
    (arXiv:1707.03237), not differentiated."""
    c = pred.shape[-1]
    counts = torch.bincount(torch.clamp(target.reshape(-1).long(), 0, c - 1),
                            minlength=c).float()
    freq = counts / torch.clamp(counts.sum(), min=1.0)
    weight = ((1.0 - freq) / torch.clamp(freq, min=1e-8)).detach()
    return cross_entropy_loss(pred, target, weight=weight,
                              ignore_index=ignore_index)


def pixel_wise_cross_entropy_loss(pred, target, pixel_weights):
    logp = torch.log_softmax(pred, dim=-1)
    nll = -torch.gather(logp, -1, target.long()[..., None]).squeeze(-1)
    return (nll * pixel_weights).mean()


def mse_loss(pred, target) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def l1_loss(pred, target) -> torch.Tensor:
    return (pred - target).abs().mean()


def smooth_l1_loss(pred, target, beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                       diff - 0.5 * beta).mean()


def weighted_smooth_l1_loss(pred, target, *, threshold: float,
                            initial_weight: float,
                            apply_below_threshold: bool = True):
    """Smooth L1 re-weighted by ``initial_weight`` below (or at and
    above) a target threshold."""
    diff = (pred - target).abs()
    loss = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
    mask = target < threshold if apply_below_threshold \
        else target >= threshold
    return torch.where(mask, loss * initial_weight, loss).mean()


def _skip_last_target(loss_fn):
    """All but the last target channel."""
    def wrapped(pred, target, **kw):
        return loss_fn(pred, target[..., :-1], **kw)
    return wrapped


def _masked(loss_fn, ignore_index: int):
    """Zero out the ``ignore_index`` regions of both arguments."""
    def wrapped(pred, target, **kw):
        mask = (target != ignore_index).to(pred.dtype)
        return loss_fn(pred * mask, target * mask, **kw)
    return wrapped


_LOSSES: dict[str, Callable] = {
    "DiceLoss": dice_loss,
    "GeneralizedDiceLoss": generalized_dice_loss,
    "BCEDiceLoss": bce_dice_loss,
    "BCEWithLogitsLoss": bce_with_logits,
    "CrossEntropyLoss": cross_entropy_loss,
    "WeightedCrossEntropyLoss": weighted_cross_entropy_loss,
    "PixelWiseCrossEntropyLoss": pixel_wise_cross_entropy_loss,
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "WeightedSmoothL1Loss": weighted_smooth_l1_loss,
}


def get_loss_criterion(config: dict) -> Callable:
    """``config['loss']`` = {'name', optional 'ignore_index',
    'skip_last_target', 'weight' (dropped: tensor weights are the
    caller's), loss-specific keywords}."""
    loss_config = dict(config["loss"])
    name = loss_config.pop("name")
    ignore_index = loss_config.pop("ignore_index", None)
    skip_last = loss_config.pop("skip_last_target", False)
    loss_config.pop("weight", None)
    if name not in _LOSSES:
        raise ValueError(
            f"Unsupported loss {name!r}; available: {sorted(_LOSSES)}")
    fn = _LOSSES[name]
    if loss_config:
        fn = partial(fn, **loss_config)
    if name in ("CrossEntropyLoss", "WeightedCrossEntropyLoss") and \
            ignore_index is not None:
        fn = partial(fn, ignore_index=ignore_index)
    elif ignore_index is not None:
        fn = _masked(fn, ignore_index)
    if skip_last:
        fn = _skip_last_target(fn)
    return fn
