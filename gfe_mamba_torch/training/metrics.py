"""Binary classification metrics from streaming confusion counts
(counterpart of ``gfe_mamba_tpu/training/metrics.py``): torchmetrics'
binary semantics with a 0.5 threshold, every division safe (0 where the
denominator is 0), and the arguments in the intended order
``(preds, targets)``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ConfusionCounts(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    def __add__(self, other: "ConfusionCounts") -> "ConfusionCounts":
        return ConfusionCounts(*(a + b for a, b in zip(self, other)))


class BinaryMetrics(NamedTuple):
    accuracy: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    f1: torch.Tensor
    mcc: torch.Tensor


def confusion_counts(preds: torch.Tensor, targets: torch.Tensor,
                     threshold: float = 0.5) -> ConfusionCounts:
    """preds: probabilities or hard {0,1}; targets: {0,1}."""
    p = (preds >= threshold).float().reshape(-1)
    t = (targets >= 0.5).float().reshape(-1)
    return ConfusionCounts(tp=torch.sum(p * t), fp=torch.sum(p * (1 - t)),
                           tn=torch.sum((1 - p) * (1 - t)),
                           fn=torch.sum((1 - p) * t))


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def metrics_from_counts(c: ConfusionCounts) -> BinaryMetrics:
    precision = _safe_div(c.tp, c.tp + c.fp)
    recall = _safe_div(c.tp, c.tp + c.fn)
    accuracy = _safe_div(c.tp + c.tn, c.tp + c.tn + c.fp + c.fn)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    mcc_den = torch.sqrt((c.tp + c.fp) * (c.tp + c.fn)
                         * (c.tn + c.fp) * (c.tn + c.fn))
    mcc = _safe_div(c.tp * c.tn - c.fp * c.fn, mcc_den)
    return BinaryMetrics(accuracy=accuracy, precision=precision,
                         recall=recall, f1=f1, mcc=mcc)


def binary_metrics(preds: torch.Tensor, targets: torch.Tensor,
                   threshold: float = 0.5) -> BinaryMetrics:
    return metrics_from_counts(confusion_counts(preds, targets, threshold))
