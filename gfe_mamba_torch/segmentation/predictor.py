"""Sliding-window volumetric prediction with overlap normalization
(counterpart of ``gfe_mamba_tpu/segmentation/predictor.py``; reference
pytorch3dunet/unet3d/predictor.py:57-230): iterate the patch grid,
mirror-pad a halo around each patch, run the model on batches of
equally-shaped patches, strip the halo, accumulate predictions and
per-voxel visit counts, divide at the end.

``sliding_window_predict_lazy`` keeps the prediction and count maps out
of memory: they accumulate in two memory-mapped scratch files beside the
output (the JAX package keeps them in the output HDF5 file, which needs
h5py's in-place chunk updates), normalize in 1/27-volume chunks, and
stream into the gzip-chunked output dataset through ``data/h5.py``.
The predictions file holds what JAX's holds.

``dsb_predict`` runs a 2D model over DSB2018 images and writes each
one's predictions and instance segmentation (reference
predictor.py:233-290).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np

from gfe_mamba_torch.data import h5
from gfe_mamba_torch.segmentation.slicers import SliceBuilder


def _mirror_pad(volume: np.ndarray, halo) -> np.ndarray:
    pad = [(h, h) for h in halo]
    if volume.ndim == 4:
        pad.append((0, 0))
    return np.pad(volume, pad, mode="reflect")


def _iter_patch_predictions(predict_fn, volume, patch_shape, stride_shape,
                            halo, batch_size):
    """Yield (slice_tuple, halo-stripped prediction) over the patch
    grid, running ``predict_fn`` on batches of halo-padded patches."""
    spatial = volume.shape[:3]
    padded = _mirror_pad(volume, halo)
    slices = SliceBuilder(spatial, patch_shape, stride_shape).raw_slices
    for start in range(0, len(slices), batch_size):
        chunk = slices[start:start + batch_size]
        patches = [padded[tuple(slice(s.start, s.stop + 2 * h)
                                for s, h in zip(sl, halo))] for sl in chunk]
        out = np.asarray(predict_fn(np.stack(patches)))
        for sl, pred in zip(chunk, out):
            if any(halo):
                pred = pred[tuple(
                    slice(h, pred.shape[i] - h) if h else slice(None)
                    for i, h in enumerate(halo))]
            yield sl, pred


def _as_volume(volume) -> np.ndarray:
    volume = np.asarray(volume)
    return volume[..., None] if volume.ndim == 3 else volume


def sliding_window_predict(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    volume: np.ndarray,
    patch_shape,
    stride_shape,
    *,
    halo_shape=(0, 0, 0),
    out_channels: int = 1,
    batch_size: int = 4,
) -> np.ndarray:
    """Predict a full (X, Y, Z[, C]) volume patch-wise.

    ``predict_fn``: batched forward (B, px, py, pz, C) -> (B, px, py, pz,
    out_channels) on numpy arrays (patches arrive halo-padded; the halo is
    stripped here)."""
    volume = _as_volume(volume)
    spatial = volume.shape[:3]
    prediction = np.zeros(spatial + (out_channels,), np.float32)
    counts = np.zeros(spatial + (1,), np.float32)
    for sl, pred in _iter_patch_predictions(
            predict_fn, volume, patch_shape, stride_shape,
            tuple(halo_shape), batch_size):
        prediction[sl] += pred
        counts[sl] += 1.0
    return prediction / np.clip(counts, 1.0, None)


def sliding_window_predict_lazy(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    volume: np.ndarray,
    patch_shape,
    stride_shape,
    out_path: str,
    *,
    halo_shape=(0, 0, 0),
    out_channels: int = 1,
    batch_size: int = 4,
    dataset_name: str = "predictions",
) -> str:
    """Like :func:`sliding_window_predict`, written to ``out_path``
    (dataset ``dataset_name``, ``spatial + (out_channels,)`` f32, gzip,
    h5py's chunks) without holding the maps in memory (module
    docstring): uint8 visit counts as in the JAX package, each 1/27 chunk
    of counts reset to 1 once normalized, so overlapping chunks never
    divide twice."""
    volume = _as_volume(volume)
    spatial = volume.shape[:3]
    acc_path, cnt_path = out_path + ".acc", out_path + ".cnt"
    try:
        prediction = np.memmap(acc_path, np.float32, "w+",
                               shape=spatial + (out_channels,))
        counts = np.memmap(cnt_path, np.uint8, "w+", shape=spatial)
        for sl, pred in _iter_patch_predictions(
                predict_fn, volume, patch_shape, stride_shape,
                tuple(halo_shape), batch_size):
            prediction[sl] = prediction[sl] + pred
            counts[sl] = counts[sl] + 1
        chunk_shape = tuple(max(1, s // 3) for s in spatial)
        for sl in SliceBuilder(spatial, chunk_shape, chunk_shape).raw_slices:
            c = counts[sl].astype(np.float32)[..., None]
            prediction[sl] = prediction[sl] / np.clip(c, 1.0, None)
            counts[sl] = 1
        prediction.flush()
        h5.write(out_path, {dataset_name: prediction})
        del prediction, counts
    finally:
        for path in (acc_path, cnt_path):
            if os.path.exists(path):
                os.remove(path)
    return out_path


def pmaps_to_segmentation(pred: np.ndarray, threshold: float = 0.5
                          ) -> np.ndarray:
    """Threshold probability maps and label their connected components
    with full connectivity (``scipy.ndimage.label``), as uint16."""
    from scipy.ndimage import label

    mask = np.asarray(pred) > threshold
    structure = np.ones((3,) * mask.ndim, dtype=bool)
    lab, _ = label(mask, structure=structure)
    return lab.astype("uint16")


def dsb_predict(predict_fn: Callable[[np.ndarray], np.ndarray],
                items: Iterable, output_dir: str | None = None, *,
                save_segmentation: bool = True,
                threshold: float = 0.5) -> list[str]:
    """DSB2018Predictor (reference predictor.py:233-290): run
    ``predict_fn`` on each image and write its ``predictions`` (squeezed)
    and, unless ``save_segmentation`` is off, their
    :func:`pmaps_to_segmentation` as ``segmentation`` to
    ``<stem>_predictions.h5`` beside the source path (or in
    ``output_dir``), gzip through ``data/h5.py``.

    ``items``: pairs ``(image, source path)``, the image ``(X, Y[, C])``,
    or a batch ``(B, X, Y[, C])`` paired with a list of one path per
    image.  Returns the files written."""
    written = []
    for img, path in items:
        img = np.asarray(img)
        paths = [path] if isinstance(path, (str, os.PathLike)) \
            else list(path)
        batch = img if len(paths) > 1 or img.ndim == 4 else img[None]
        preds = np.asarray(predict_fn(batch))
        if len(preds) != len(paths):
            raise ValueError(
                f"dsb_predict: {len(preds)} predictions for {len(paths)} "
                f"output path(s) -- a batched image must be paired with a "
                f"list of one path per batch item")
        for pred, source in zip(preds, paths):
            pred = np.squeeze(pred)
            out_file = os.path.splitext(source)[0] + "_predictions.h5"
            if output_dir is not None:
                out_file = os.path.join(output_dir,
                                        os.path.basename(out_file))
            datasets = {"predictions": pred}
            if save_segmentation:
                datasets["segmentation"] = pmaps_to_segmentation(pred,
                                                                 threshold)
            h5.write(out_file, datasets)
            written.append(out_file)
    return written
