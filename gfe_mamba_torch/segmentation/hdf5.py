"""HDF5 patch datasets (counterpart of
``gfe_mamba_tpu/segmentation/hdf5.py``; reference
pytorch3dunet/datasets/hdf5.py) over ``data/h5.py``, without h5py.

``HDF5Dataset`` iterates SliceBuilder patches over the ``raw`` / ``label``
datasets of one .h5 file, through the config's augmentation pipeline.
Eager mode loads both volumes once; lazy mode reads each patch from the
file on demand (only the chunks it touches).  The files store (C, X, Y,
Z) or (X, Y, Z); channels are moved last.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

from gfe_mamba_torch.data import h5
from gfe_mamba_torch.segmentation.slicers import (FilterSliceBuilder,
                                                  SliceBuilder)
from gfe_mamba_torch.segmentation.transforms import build_transforms


def _to_channels_last(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # (C, X, Y, Z) -> (X, Y, Z, C)
        return np.moveaxis(arr, 0, -1)
    return arr


def traverse_h5_paths(file_paths: Sequence[str]) -> list[str]:
    """Directories expanded to the .h5 / .hdf / .hdf5 / .hd5 files inside
    them, each kind sorted; files kept as given."""
    results = []
    for path in file_paths:
        if os.path.isdir(path):
            for ext in ("*.h5", "*.hdf", "*.hdf5", "*.hd5"):
                results.extend(sorted(glob.glob(os.path.join(path, ext))))
        else:
            results.append(path)
    return results


class HDF5Dataset:
    """Patches of one file: ``{"raw", "slice_index"}`` items, with
    ``"label"`` outside the test phase when the file holds one; raw (and
    label) f32 with a trailing channel axis.  ``FilterSliceBuilder``
    needs the label; without one the plain grid is used."""

    def __init__(self, file_path: str, phase: str, slice_builder_config: dict,
                 transformer_config: Sequence[dict] | None = None,
                 raw_internal_path: str = "raw",
                 label_internal_path: str = "label",
                 weight_internal_path: str | None = None,
                 lazy: bool = False, seed: int = 47):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"unknown phase {phase!r}")
        self.phase = phase
        self.lazy = lazy
        self.file_path = file_path
        self.raw_path = raw_internal_path
        self.label_path = label_internal_path
        self.weight_path = weight_internal_path

        with h5.File(file_path) as f:
            raw = _to_channels_last(f[raw_internal_path][...])
            label = None
            if phase != "test" and label_internal_path in f:
                label = _to_channels_last(f[label_internal_path][...])
        if not lazy:
            self._raw, self._label = raw, label
        else:
            self._raw = self._label = None

        sb_config = dict(slice_builder_config)
        name = sb_config.pop("name", "SliceBuilder")
        patch = sb_config.pop("patch_shape")
        stride = sb_config.pop("stride_shape")
        if name == "FilterSliceBuilder" and label is not None:
            self.slices = FilterSliceBuilder(raw.shape, patch, stride,
                                             label=label, **sb_config)
        else:
            self.slices = SliceBuilder(raw.shape, patch, stride)

        self.transform = (build_transforms(transformer_config, seed)
                          if transformer_config else None)

    def _read(self, internal_path: str, sl):
        if not self.lazy:
            src = self._raw if internal_path == self.raw_path else self._label
            return src[sl]
        with h5.File(self.file_path) as f:
            arr = f[internal_path]
            if arr.ndim == 4:  # (C, X, Y, Z)
                return np.moveaxis(arr[(slice(None),) + sl], 0, -1)
            return arr[sl]

    def __len__(self) -> int:
        return len(self.slices)

    def __getitem__(self, index: int) -> dict:
        sl = self.slices[index]
        raw = np.asarray(self._read(self.raw_path, sl), np.float32)
        if raw.ndim == 3:
            raw = raw[..., None]
        if self.transform is not None:
            raw = self.transform(raw)
        item = {"raw": raw, "slice_index": np.int32(index)}
        if self.phase != "test" and (self._label is not None or self.lazy):
            label = np.asarray(self._read(self.label_path, sl), np.float32)
            if label.ndim == 3:
                label = label[..., None]
            item["label"] = label
        return item


def save_predictions_h5(path: str, prediction: np.ndarray,
                        dataset_name: str = "predictions") -> None:
    """``prediction`` (X, Y, Z, C) written channel-first, gzip-chunked."""
    h5.write(path, {dataset_name: np.moveaxis(prediction, -1, 0)})
