"""Datasets: MRI->PET pairs and MRI+table classification items
(counterpart of ``gfe_mamba_tpu/data/datasets.py``, on ``data/table.py``
instead of pandas).

Re-implements the reference datasets on top of the native NIfTI codec:

* ``MRI2PETDataset`` (threed_loader.py:47-81): per-patient directories
  holding ``mri.nii.gz`` / ``pet.nii.gz``; pipeline = load ->
  adaptive_normal(MRI) -> crop-foreground-of-PET -> resize both to
  (160,160,96) -> scale PET intensity [0,2] -> [-1,1].
* ``MRIClassifyDataset`` (pic_table_loader.py:46-127): flat directory of
  ``PTID-YYYY_MM_DD_hh_mm_ss.f-LABEL.nii.gz`` files; label parsed from
  the filename, tabular row joined by PTID + LABEL + exam date within
  30 days, with the ``days_threshold`` exclusion filter
  (pic_table_loader.py:62-75).

Volumes are returned channels-last ``(H, W, D, 1)`` float32.  The
native library decodes, normalises and resamples when it is built
(``GFE_NATIVE_IO=0`` disables it); the numpy path is the JAX package's.
``CODEC_RUNS`` counts the volumes each codec decoded.  The table row of
an item is its row number in the CSV (the frame's index label under
pandas' default index), found and filtered as the JAX dataset does.
"""

from __future__ import annotations

import math
import os
import re
from collections import Counter
from datetime import datetime
from glob import glob
from os.path import join

import numpy as np

from gfe_mamba_torch.data.loader import DataLoader
from gfe_mamba_torch.data.nifti import load_nifti
from gfe_mamba_torch.data.table import Table, prepare_table, read_csv

CODEC_RUNS: Counter = Counter()


def _native_io_enabled() -> bool:
    """Use the C++ decode+normalize+resample path when built
    (GFE_NATIVE_IO=0 disables)."""
    if os.environ.get("GFE_NATIVE_IO", "1") == "0":
        return False
    from gfe_mamba_torch.data import native
    return native.available()


def _load_preprocessed(path: str, desired_shape, normalize: bool) -> np.ndarray:
    """Decode a NIfTI file -> (adaptive-normalized) -> resampled volume,
    through the native library when available (bit-compatible with the
    Python path; parity tested)."""
    if _native_io_enabled():
        from gfe_mamba_torch.data import native
        try:
            vol = native.load_volume(path, desired_shape,
                                     normalize=normalize)
            CODEC_RUNS["native"] += 1
            return vol
        except (IOError, RuntimeError):
            pass  # fall back to the Python codec
    CODEC_RUNS["python"] += 1
    vol, _ = load_nifti(path)
    if vol.ndim > 3:
        vol = vol[..., 0]
    if normalize:
        vol = np_adaptive_normal(vol)
    return np_resize(vol, desired_shape)


def date_difference(date1: str, date2: str) -> int:
    """Days between YYYY-MM-DD dates (reference common.py:28-40)."""
    d1 = datetime.strptime(date1, "%Y-%m-%d")
    d2 = datetime.strptime(date2, "%Y-%m-%d")
    return abs((d2 - d1).days)


def np_adaptive_normal(img: np.ndarray, min_p: float = 0.001,
                       max_p: float = 0.999) -> np.ndarray:
    """Numpy twin of ops.volumetric.adaptive_normal (same index math)."""
    pixel = np.sort(img[img >= 0].reshape(-1))
    if pixel.size == 0:
        return np.clip(img, -1.0, 1.0)
    def pick(p):
        idx = int(np.floor((pixel.size - 1) * p + 0.5))
        return pixel[min(max(idx, 0), pixel.size - 1)]
    vmin, vmax = pick(min_p), pick(max_p)
    mean, std = (vmax + vmin) / 2.0, (vmax - vmin) / 2.0
    if std <= 0:
        return np.clip(img, -1.0, 1.0)
    return np.clip((img - mean) / std, -1.0, 1.0).astype(np.float32)


def np_resize(img: np.ndarray, shape) -> np.ndarray:
    """Half-pixel (align_corners=False) separable linear resample --
    identical math to ops.volumetric.crop_resize and the native C++
    resampler, and the same convention as torch/MONAI interpolation."""
    out = np.asarray(img, np.float32)
    for axis, size in enumerate(shape):
        n = out.shape[axis]
        if n == size:
            continue
        centers = (np.arange(size, dtype=np.float32) + 0.5) * n / size - 0.5
        centers = np.clip(centers, 0, n - 1)
        i0 = np.floor(centers).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        frac = (centers - i0).reshape(
            [-1 if a == axis else 1 for a in range(out.ndim)])
        out = (np.take(out, i0, axis=axis) * (1 - frac)
               + np.take(out, i1, axis=axis) * frac)
    return out.astype(np.float32)


def np_crop_foreground(img: np.ndarray, source: np.ndarray) -> np.ndarray:
    mask = source > 0
    if not mask.any():
        return img
    slices = []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        line = mask.any(axis=other)
        idx = np.nonzero(line)[0]
        slices.append(slice(int(idx[0]), int(idx[-1]) + 1))
    return img[tuple(slices)]


def np_scale_intensity(img, a_min, a_max, b_min, b_max, clip=True):
    out = (img - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    return np.clip(out, b_min, b_max) if clip else out


class MRI2PETDataset:
    """Paired MRI/PET volumes for Stage-1 GAN training
    (threed_loader.py:47-81)."""

    def __init__(self, data_path: str, desired_shape=(160, 160, 96)):
        self.parent = data_path
        self.subjects = sorted(os.listdir(data_path))
        self.desired_shape = tuple(desired_shape)

    def __len__(self) -> int:
        return len(self.subjects)

    def __getitem__(self, index: int) -> dict:
        subject = join(self.parent, self.subjects[index])
        mri_path = join(subject, "mri.nii.gz")
        if not os.path.exists(mri_path):
            mri_path = join(subject, "mri.nii")
        pet_path = mri_path.replace("mri.nii", "pet.nii")
        mri = _load_preprocessed(mri_path, self.desired_shape,
                                 normalize=True)
        # the PET is cropped to its own foreground bbox before resizing
        # (CropForegroundd keys=['label'], threed_loader.py:60-61), so it
        # stays on the Python path
        CODEC_RUNS["python"] += 1
        pet, _ = load_nifti(pet_path)
        pet = np_crop_foreground(pet, pet)
        pet = np_resize(pet, self.desired_shape)
        pet = np_scale_intensity(pet, 0.0, 2.0, -1.0, 1.0)
        return {
            "image": mri[..., None].astype(np.float32),
            "label": pet[..., None].astype(np.float32),
            "name": mri_path,
        }


_FILENAME_RE = re.compile(r"(.+?)-(\d{4})_(\d{2})_(\d{2}).*-(\d)\.nii(\.gz)?$")


def parse_classify_filename(name: str):
    """PTID-YYYY_MM_DD_hh_mm_ss.f-LABEL.nii.gz -> (ptid, date, label)
    (pic_table_loader.py:119-124)."""
    m = _FILENAME_RE.match(os.path.basename(name))
    if not m:
        raise ValueError(f"unparseable classify filename {name!r}")
    ptid, y, mo, d, label = m.group(1), m.group(2), m.group(3), m.group(4), m.group(5)
    return ptid, f"{y}-{mo}-{d}", int(label)


class MRIClassifyDataset:
    """MRI volume + tabular row + conversion label for Stage-2
    (pic_table_loader.py:46-127)."""

    def __init__(self, data_path: str, table_path: str = "",
                 desired_shape=(160, 160, 96), days_threshold: int = -1,
                 preprocessor=None):
        self.desired_shape = tuple(desired_shape)
        files = sorted(glob(join(data_path, "*.nii.gz")) +
                       glob(join(data_path, "*.nii")))
        self.import_table = bool(table_path)
        self.items = []
        if not self.import_table:
            self.items = [(f, -1) for f in files]
            self.table = None
            return

        raw = read_csv(table_path)
        kept = []
        for path in files:
            try:
                ptid, date, label = parse_classify_filename(path)
            except ValueError:
                continue
            row = self._find_row(raw, ptid, date, label)
            if row is None:
                continue
            if "date_diff" in raw.columns and \
                    raw.cell(row, "date_diff") <= days_threshold:
                continue  # too-close visit exclusion (pic_table_loader.py:71-73)
            kept.append((path, row))
        self.items = kept
        self.table = prepare_table(raw, preprocessor=preprocessor)

    @staticmethod
    def _find_row(table: Table, ptid: str, date: str, label: int):
        """Closest same-PTID same-LABEL visit within 30 days
        (pic_table_loader.py:78-102); the row's number in the CSV.  A
        PTID column of numbers matches no file's PTID, as under pandas."""
        if not table.is_object("PTID"):
            return None
        best, best_idx = 31, None
        for index, value in enumerate(table.data["PTID"]):
            if value != ptid:
                continue
            if "LABEL" not in table.columns:
                continue
            cell = table.cell(index, "LABEL")
            if isinstance(cell, float) and math.isnan(cell):
                continue
            if int(cell) != label:
                continue
            try:
                diff = date_difference(str(table.cell(index, "EXAMDATE")),
                                       date)
            except ValueError:
                continue
            if diff < best:
                best, best_idx = diff, index
            if best == 0:
                break
        return best_idx

    @property
    def num_cat(self):
        return self.table["num_cat"] if self.table is not None else []

    @property
    def num_cont(self):
        return self.table["num_cont"] if self.table is not None else 0

    @property
    def preprocessor(self):
        return self.table["preprocessor"]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        path, row = self.items[index]
        _, _, label = parse_classify_filename(path)
        vol = _load_preprocessed(path, self.desired_shape, normalize=True)
        item = {
            "image": vol[..., None].astype(np.float32),
            "label": np.int32(label),
            "name": os.path.basename(path),
        }
        if self.import_table:
            pos = row
            item["cate_x"] = self.table["cate_x"][pos].astype(np.int32)
            item["conti_x"] = self.table["conti_x"][pos].astype(np.float32)
        return item

    def load_batch(self, indices) -> "dict | None":
        """Batch fast path: one call into the C++ threaded decoder
        (native/gfe_io.cpp gfe_load_batch) for all volumes -- the
        DataLoader uses this instead of per-item Python decode when the
        native library is built.  Returns None to request fallback."""
        if not _native_io_enabled():
            return None
        from gfe_mamba_torch.data import native
        indices = [int(i) for i in indices]
        paths = [self.items[i][0] for i in indices]
        try:
            vols = native.load_batch(
                paths, self.desired_shape, normalize=True,
                num_threads=min(8, max(1, len(paths))))
        except (IOError, RuntimeError):
            return None
        CODEC_RUNS["native"] += len(paths)
        batch = {
            "image": vols[..., None].astype(np.float32),
            "label": np.asarray(
                [parse_classify_filename(p)[2] for p in paths], np.int32),
            "name": [os.path.basename(p) for p in paths],
        }
        if self.import_table:
            pos = [self.items[i][1] for i in indices]
            batch["cate_x"] = self.table["cate_x"][pos].astype(np.int32)
            batch["conti_x"] = self.table["conti_x"][pos].astype(np.float32)
        return batch


def form_dataloader(updir: str, image_size, batch_size: int,
                    shuffle: bool = True, **kwargs) -> DataLoader:
    """threed_loader.py:262-264."""
    return DataLoader(MRI2PETDataset(updir, image_size), batch_size,
                      shuffle=shuffle, drop_last=True, **kwargs)


def classi_dataloader(updir: str, image_size, batch_size: int,
                      table_path: str, shuffle: bool = True,
                      days_threshold: int = -1, **kwargs) -> DataLoader:
    """pic_table_loader.py:131-133."""
    dataset = MRIClassifyDataset(updir, table_path, image_size,
                                 days_threshold=days_threshold)
    return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=True,
                      **kwargs)
