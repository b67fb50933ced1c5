"""Segmentation evaluation metrics (counterpart of
``gfe_mamba_tpu/segmentation/metrics.py``; reference unet3d/metrics.py
factory + seg_metrics.py IoU-matrix scores).

``get_evaluation_metric(config)`` over: DiceCoefficient, MeanIoU, PSNR,
MSE (torch, on the tensors' device), plus the IoU-matrix instance scores
and the Adapted Rand and average-precision families, which run on host
numpy and scipy (the port's own copy of the JAX package's, taking a torch
tensor as well as an array).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from gfe_mamba_torch.segmentation.losses import compute_per_channel_dice


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dice_coefficient(pred, target, epsilon: float = 1e-6) -> torch.Tensor:
    """Soft Dice averaged over channels."""
    return compute_per_channel_dice(pred, target, epsilon=epsilon).mean()


def mean_iou(pred, target, threshold: float = 0.5) -> torch.Tensor:
    """Binarized per-channel IoU, averaged; a channel empty in both
    counts 1."""
    p = pred > threshold
    t = target > 0.5
    axes = tuple(range(pred.dim() - 1))
    inter = (p & t).float().sum(axes)
    union = (p | t).float().sum(axes)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       1.0).mean()


def psnr(pred, target) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    rng = target.max() - target.min()
    return 20 * torch.log10(torch.clamp(rng, min=1e-12)) \
        - 10 * torch.log10(torch.clamp(mse, min=1e-12))


def mse_metric(pred, target) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


# ---------------------------------------------------------------------------
# instance-level scores via the IoU matrix (seg_metrics.py)

def _label_components(mask: np.ndarray) -> np.ndarray:
    from scipy.ndimage import label
    labeled, _ = label(mask)
    return labeled


def iou_matrix(pred_labels: np.ndarray, gt_labels: np.ndarray) -> np.ndarray:
    """(n_pred, n_gt) IoU matrix between instance label maps
    (seg_metrics.py:5-40)."""
    n_pred = int(pred_labels.max())
    n_gt = int(gt_labels.max())
    matrix = np.zeros((n_pred, n_gt), np.float64)
    for i in range(1, n_pred + 1):
        p = pred_labels == i
        p_sum = p.sum()
        touching = np.unique(gt_labels[p])
        for j in touching:
            if j == 0:
                continue
            g = gt_labels == j
            inter = np.logical_and(p, g).sum()
            union = p_sum + g.sum() - inter
            matrix[i - 1, j - 1] = inter / union if union else 0.0
    return matrix


def instance_scores(pred_mask: np.ndarray, gt_mask: np.ndarray,
                    iou_threshold: float = 0.5) -> dict:
    """Instance precision/recall/F1/accuracy/AP at an IoU threshold
    (seg_metrics.py:43-123)."""
    pred_labels = _label_components(_host(pred_mask) > 0)
    gt_labels = _label_components(_host(gt_mask) > 0)
    matrix = iou_matrix(pred_labels, gt_labels)
    n_pred, n_gt = matrix.shape
    if n_gt == 0 and n_pred == 0:
        return {"precision": 1.0, "recall": 1.0, "f1": 1.0,
                "accuracy": 1.0, "ap": 1.0}
    matched = matrix >= iou_threshold
    tp = int(np.count_nonzero(matched.any(axis=1)))
    fp = n_pred - tp
    fn = n_gt - int(np.count_nonzero(matched.any(axis=0)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    accuracy = tp / (tp + fp + fn) if tp + fp + fn else 0.0
    return {"precision": precision, "recall": recall, "f1": f1,
            "accuracy": accuracy, "ap": accuracy}


# ---------------------------------------------------------------------------
# Adapted Rand error family (reference metrics.py:107-257) -- host numpy.
#
# Layout note: the reference operates on NCDHW torch tensors; this repo
# is channels-LAST everywhere, so the functors below take
# ``(B, *spatial, C)`` arrays (torch or numpy) and return a python float.

def contingency_table(seg_true: np.ndarray, seg_test: np.ndarray
                      ) -> np.ndarray:
    """Dense (n_true, n_test) joint label-count matrix (the skimage
    sparse contingency_table, seg_metrics.py:2, materialized).

    Returns ``(counts, true_labels, test_labels)`` with labels sorted
    ascending (so background 0, when present, is row/col 0)."""
    seg_true = np.asarray(seg_true).ravel()
    seg_test = np.asarray(seg_test).ravel()
    true_labels, true_idx = np.unique(seg_true, return_inverse=True)
    test_labels, test_idx = np.unique(seg_test, return_inverse=True)
    n_true, n_test = len(true_labels), len(test_labels)
    counts = np.bincount(true_idx * n_test + test_idx,
                         minlength=n_true * n_test)
    return counts.reshape(n_true, n_test), true_labels, test_labels


def adapted_rand_error(seg_true: np.ndarray, seg_test: np.ndarray, *,
                       alpha: float = 0.5,
                       ignore_labels: tuple = ()) -> tuple:
    """SNEMI3D Adapted Rand error (skimage.metrics.adapted_rand_error
    semantics, used at reference metrics.py:162).

    Returns ``(are, precision, recall)`` where precision/recall are the
    pair-counting rates and ``are = 1 - F_alpha``.
    """
    seg_true = np.asarray(seg_true).ravel()
    seg_test = np.asarray(seg_test).ravel()
    if ignore_labels:
        keep = ~np.isin(seg_true, list(ignore_labels))
        seg_true, seg_test = seg_true[keep], seg_test[keep]
    c, _, _ = contingency_table(seg_true, seg_test)
    c = c.astype(np.float64)
    n = c.sum()
    # ordered co-clustered pairs (excluding self-pairs): sum c^2 - n
    sum_p2 = float((c * c).sum() - n)
    a = c.sum(axis=1)
    b = c.sum(axis=0)
    sum_a2 = float(a @ a - n)   # pairs co-clustered in the ground truth
    sum_b2 = float(b @ b - n)   # pairs co-clustered in the prediction
    precision = sum_p2 / sum_b2 if sum_b2 > 0 else 0.0
    recall = sum_p2 / sum_a2 if sum_a2 > 0 else 0.0
    denom = alpha * sum_a2 + (1.0 - alpha) * sum_b2
    fscore = sum_p2 / denom if denom > 0 else 0.0
    return 1.0 - fscore, precision, recall


def _split_channels_last(vol: np.ndarray) -> np.ndarray:
    """(*spatial, C) -> (C, *spatial) channel stack."""
    return np.moveaxis(np.asarray(vol), -1, 0)


def _select_target_channel(target: np.ndarray, use_last: bool) -> np.ndarray:
    """(B, *spatial, C) -> (B, *spatial) picking last/first channel
    (reference metrics.py:138-142 with channels-last layout)."""
    target = _host(target)
    return target[..., -1] if use_last else target[..., 0]


class AdaptedRandError:
    """Mean min-over-channels ARand error across the batch (reference
    metrics.py:107-179).  ``input`` is treated as a segmentation volume
    per channel unless a subclass overrides ``input_to_segm``."""

    def __init__(self, use_last_target: bool = False,
                 ignore_index: int | None = None, **kwargs):
        self.use_last_target = use_last_target
        self.ignore_index = ignore_index

    def __call__(self, input, target) -> float:
        input = _host(input)
        target = _select_target_channel(target, self.use_last_target)
        target = target.astype(np.int32)
        if self.ignore_index is not None:
            target = np.where(target == self.ignore_index, 0, target)
        per_batch = []
        for vol, tgt in zip(input, target):
            if np.all(tgt == tgt.flat[0]):
                # single-label ground truth: ARand undefined, skip as 0
                per_batch.append(0.0)
                continue
            segm = self.input_to_segm(vol)
            assert segm.ndim == tgt.ndim + 1
            per_batch.append(min(
                adapted_rand_error(tgt, channel_segm)[0]
                for channel_segm in segm))
        return float(np.mean(per_batch))

    def input_to_segm(self, vol: np.ndarray) -> np.ndarray:
        """(*spatial, C) network output -> (K, *spatial) segmentations."""
        return _split_channels_last(vol)


class BoundaryAdaptedRandError(AdaptedRandError):
    """ARand between thresholded boundary probability maps and the
    target segmentation (reference metrics.py:182-220).  Each threshold
    is applied to the ORIGINAL probability map (the reference re-uses
    the already-binarized map for later thresholds -- a compounding
    quirk not replicated)."""

    def __init__(self, thresholds=None, use_last_target: bool = True,
                 ignore_index=None, input_channel: int | None = None,
                 invert_pmaps: bool = True, **kwargs):
        super().__init__(use_last_target=use_last_target,
                         ignore_index=ignore_index)
        self.thresholds = list(thresholds) if thresholds is not None \
            else [0.3, 0.4, 0.5, 0.6]
        self.input_channel = input_channel
        self.invert_pmaps = invert_pmaps

    def input_to_segm(self, vol: np.ndarray) -> np.ndarray:
        channels = _split_channels_last(vol)
        if self.input_channel is not None:
            channels = channels[self.input_channel:self.input_channel + 1]
        segs = []
        for pmap in channels:
            for th in self.thresholds:
                mask = pmap > th
                if self.invert_pmaps:
                    # boundary signal becomes background for labeling
                    mask = np.logical_not(mask)
                segs.append(_label_components(mask.astype(np.uint8)))
        return np.stack(segs)


class GenericAdaptedRandError(AdaptedRandError):
    """ARand over selected (optionally inverted) input channels at
    multiple thresholds (reference metrics.py:223-257)."""

    def __init__(self, input_channels, thresholds=None,
                 use_last_target: bool = True, ignore_index=None,
                 invert_channels=None, **kwargs):
        super().__init__(use_last_target=use_last_target,
                         ignore_index=ignore_index)
        assert isinstance(input_channels, (list, tuple))
        self.input_channels = list(input_channels)
        self.thresholds = list(thresholds) if thresholds is not None \
            else [0.3, 0.4, 0.5, 0.6]
        self.invert_channels = list(invert_channels or [])

    def input_to_segm(self, vol: np.ndarray) -> np.ndarray:
        channels = _split_channels_last(vol)
        picked = []
        for i in self.input_channels:
            c = channels[i]
            if i in self.invert_channels:
                c = 1 - c
            picked.append(c)
        segs = []
        for pmap in picked:
            for th in self.thresholds:
                segs.append(_label_components((pmap > th).astype(np.uint8)))
        return np.stack(segs)


# ---------------------------------------------------------------------------
# Average-precision family (reference metrics.py:260-401 over
# seg_metrics.py SegmentationMetrics / Accuracy / AveragePrecision)

def _contingency_iou_matrix(gt: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Full IoU matrix incl. the background row/col (seg_metrics.py:26-46).
    Rows = gt instances, cols = seg instances, both relabeled to dense
    ids with 0 (background) first when present."""
    c, _, _ = contingency_table(gt, seg)
    c = c.astype(np.float64)
    n_gt = c.sum(axis=1, keepdims=True)
    n_seg = c.sum(axis=0, keepdims=True)
    union = n_gt + n_seg - c
    with np.errstate(invalid="ignore"):
        iou = np.where(union > 0, c / union, 0.0)
    return iou


class SegmentationScores:
    """Pair of instance maps -> precision/recall/accuracy/F1 at an IoU
    threshold (seg_metrics.py:49-90).  Background (dense id 0) row/col
    is dropped before matching."""

    def __init__(self, gt: np.ndarray, seg: np.ndarray):
        self.iou = _contingency_iou_matrix(_host(gt), _host(seg))

    def metrics(self, iou_threshold: float) -> dict:
        iou = self.iou[1:, 1:]
        detection = (iou > iou_threshold).astype(np.uint8)
        n_gt, n_seg = detection.shape
        if min(n_gt, n_seg) == 0 or not detection.any():
            tp = fp = fn = 0
        else:
            tp = int(np.count_nonzero(detection.sum(axis=1)))
            fn = n_gt - tp
            fp = n_seg - int(np.count_nonzero(detection.sum(axis=0)))
        precision = tp / (tp + fp) if tp > 0 else 0
        recall = tp / (tp + fn) if tp > 0 else 0
        acc = tp / (tp + fp + fn) if tp > 0 else 0
        f1 = (2 * tp) / (2 * tp + fp + fn) if tp > 0 else 0
        return {"precision": precision, "recall": recall,
                "accuracy": acc, "f1": f1}


class InstanceAccuracy:
    """Accuracy TP/(TP+FP+FN) at one IoU threshold (seg_metrics.py:93-105)."""

    def __init__(self, iou_threshold: float = 0.5):
        self.iou_threshold = iou_threshold

    def __call__(self, input_seg, gt_seg) -> float:
        return SegmentationScores(gt_seg, input_seg).metrics(
            self.iou_threshold)["accuracy"]


class InstanceAveragePrecision:
    """Mean accuracy over IoU 0.50:0.05:0.95 (seg_metrics.py:108-123,
    the Kaggle DSB2018 metric)."""

    def __init__(self):
        self.iou_range = np.linspace(0.50, 0.95, 10)

    def __call__(self, input_seg, gt_seg) -> float:
        sm = SegmentationScores(gt_seg, input_seg)
        return float(np.mean([sm.metrics(iou)["accuracy"]
                              for iou in self.iou_range]))


class GenericAveragePrecision:
    """Batch-mean, max-over-channels AP/accuracy between predicted and
    ground-truth instance segmentations (reference metrics.py:260-331)."""

    def __init__(self, min_instance_size: int | None = None,
                 use_last_target: bool = False, metric: str = "ap",
                 **kwargs):
        self.min_instance_size = min_instance_size
        self.use_last_target = use_last_target
        assert metric in ("ap", "acc")
        self.metric = (InstanceAveragePrecision() if metric == "ap"
                       else InstanceAccuracy(iou_threshold=0.5))

    def __call__(self, input, target) -> float:
        target = _host(target)
        if target.ndim == 5:
            target = _select_target_channel(target, self.use_last_target)
        multi_head = isinstance(input, tuple)
        if multi_head:
            input1, input2 = (_host(i) for i in input)
        else:
            input1 = input2 = _host(input)
        batch_aps = []
        for inp1, inp2, tar in zip(input1, input2, target):
            inp = (inp1, inp2) if multi_head else inp1
            segs = self.input_to_seg(inp, tar)
            assert segs.ndim == tar.ndim + 1
            tar = self._filter_instances(self.target_to_seg(tar))
            batch_aps.append(max(
                self.metric(self._filter_instances(seg), tar)
                for seg in segs))
        return float(np.mean(batch_aps))

    def _filter_instances(self, seg: np.ndarray) -> np.ndarray:
        if self.min_instance_size is not None:
            seg = seg.copy()
            labels, counts = np.unique(seg, return_counts=True)
            for label, count in zip(labels, counts):
                if count < self.min_instance_size:
                    seg[seg == label] = 0
        return seg

    def input_to_seg(self, inp, target=None) -> np.ndarray:
        raise NotImplementedError

    def target_to_seg(self, target: np.ndarray) -> np.ndarray:
        return target


class BlobsAveragePrecision(GenericAveragePrecision):
    """AP from a foreground probability channel (metrics.py:333-354)."""

    def __init__(self, thresholds=None, metric: str = "ap",
                 min_instance_size=None, input_channel: int = 0, **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True, metric=metric)
        self.thresholds = list(thresholds) if thresholds is not None \
            else [0.4, 0.5, 0.6, 0.7, 0.8]
        self.input_channel = input_channel

    def input_to_seg(self, inp, target=None) -> np.ndarray:
        pmap = _split_channels_last(inp)[self.input_channel]
        return np.stack([
            _label_components((pmap > th).astype(np.uint8))
            for th in self.thresholds])


class BlobsBoundaryAveragePrecision(GenericAveragePrecision):
    """AP from (P_mask - P_boundary) > th (metrics.py:357-379)."""

    def __init__(self, thresholds=None, metric: str = "ap",
                 min_instance_size=None, **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True, metric=metric)
        self.thresholds = list(thresholds) if thresholds is not None \
            else [0.3, 0.4, 0.5, 0.6, 0.7]

    def input_to_seg(self, inp, target=None) -> np.ndarray:
        channels = _split_channels_last(inp)
        pmap = channels[0] - channels[1]
        return np.stack([
            _label_components((pmap > th).astype(np.uint8))
            for th in self.thresholds])


class BoundaryAveragePrecision(GenericAveragePrecision):
    """AP from an inverted boundary channel (metrics.py:382-401)."""

    def __init__(self, thresholds=None, min_instance_size=None,
                 input_channel: int = 0, **kwargs):
        super().__init__(min_instance_size=min_instance_size,
                         use_last_target=True)
        self.thresholds = list(thresholds) if thresholds is not None \
            else [0.3, 0.4, 0.5, 0.6]
        self.input_channel = input_channel

    def input_to_seg(self, inp, target=None) -> np.ndarray:
        pmap = _split_channels_last(inp)[self.input_channel]
        return np.stack([
            _label_components(np.logical_not(pmap > th).astype(np.uint8))
            for th in self.thresholds])


_METRICS: dict[str, Callable] = {
    "DiceCoefficient": dice_coefficient,
    "MeanIoU": mean_iou,
    "PSNR": psnr,
    "MSE": mse_metric,
}

_METRIC_CLASSES: dict[str, type] = {
    "AdaptedRandError": AdaptedRandError,
    "BoundaryAdaptedRandError": BoundaryAdaptedRandError,
    "GenericAdaptedRandError": GenericAdaptedRandError,
    "GenericAveragePrecision": GenericAveragePrecision,
    "BlobsAveragePrecision": BlobsAveragePrecision,
    "BlobsBoundaryAveragePrecision": BlobsBoundaryAveragePrecision,
    "BoundaryAveragePrecision": BoundaryAveragePrecision,
}


def get_evaluation_metric(config: dict) -> Callable:
    """metrics.py:430 factory: config['eval_metric'] = {'name', ...}."""
    metric_config = dict(config["eval_metric"])
    name = metric_config.pop("name")
    if name in _METRICS:
        fn = _METRICS[name]
        return partial(fn, **metric_config) if metric_config else fn
    if name in _METRIC_CLASSES:
        return _METRIC_CLASSES[name](**metric_config)
    if name in ("AveragePrecision", "InstanceScores"):
        return partial(instance_scores, **metric_config)
    names = sorted(_METRICS) + sorted(_METRIC_CLASSES) + [
        "AveragePrecision", "InstanceScores"]
    raise ValueError(f"Unsupported metric {name!r}; available: {names}")
