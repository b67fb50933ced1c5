"""Patch-grid builders for large-volume training/inference (the port's
own copy of ``gfe_mamba_tpu/segmentation/slicers.py``, numpy only).

Reference: pytorch3dunet/datasets/utils.py:39-161 -- ``SliceBuilder``
produces the overlapping patch grid over a raw/label volume pair;
``FilterSliceBuilder`` drops patches whose label foreground fraction is
below a threshold (with an acceptance probability for rejected ones).
"""

from __future__ import annotations

import numpy as np


def _gen_indices(dim_size: int, patch: int, stride: int):
    assert dim_size >= patch, (
        f"patch size {patch} larger than volume dim {dim_size}")
    for start in range(0, dim_size - patch + 1, stride):
        yield start
    if (dim_size - patch) % stride != 0:
        yield dim_size - patch


class SliceBuilder:
    """Overlapping patch grid (datasets/utils.py:39-105).  Works on
    channels-last volumes (X, Y, Z[, C]); slices cover spatial dims."""

    def __init__(self, raw_shape, patch_shape, stride_shape):
        self.patch_shape = tuple(patch_shape)
        self.stride_shape = tuple(stride_shape)
        spatial = raw_shape[:3]
        self._slices = []
        for x in _gen_indices(spatial[0], patch_shape[0], stride_shape[0]):
            for y in _gen_indices(spatial[1], patch_shape[1], stride_shape[1]):
                for z in _gen_indices(spatial[2], patch_shape[2],
                                      stride_shape[2]):
                    self._slices.append((
                        slice(x, x + patch_shape[0]),
                        slice(y, y + patch_shape[1]),
                        slice(z, z + patch_shape[2]),
                    ))

    @property
    def raw_slices(self):
        return self._slices

    def __len__(self):
        return len(self._slices)

    def __getitem__(self, i):
        return self._slices[i]


class FilterSliceBuilder(SliceBuilder):
    """Drop patches with < threshold label foreground, keeping rejected
    ones with probability ``slack_acceptance``
    (datasets/utils.py:108-161)."""

    def __init__(self, raw_shape, patch_shape, stride_shape, label=None,
                 ignore_index=None, threshold: float = 0.6,
                 slack_acceptance: float = 0.01, seed: int = 47):
        super().__init__(raw_shape, patch_shape, stride_shape)
        if label is None:
            return
        rng = np.random.default_rng(seed)
        label = np.asarray(label)
        kept = []
        for sl in self._slices:
            patch = label[sl]
            if ignore_index is not None:
                patch = patch[patch != ignore_index]
            nonzero = np.count_nonzero(patch)
            frac = nonzero / max(patch.size, 1)
            if frac > threshold or rng.random() < slack_acceptance:
                kept.append(sl)
        self._slices = kept
