"""Synthetic ADNI-like data generation for tests and smoke runs
(counterpart of ``gfe_mamba_tpu/data/synthetic.py``): the same files from
the same seed, the CSV written with ``csv`` as pandas' ``to_csv`` writes
it.

Produces the exact on-disk layout the datasets consume:

* ``make_mri2pet_tree``: per-patient dirs with mri.nii.gz / pet.nii.gz
  (threed_loader.py:68-71 layout)
* ``make_classify_tree``: flat PTID-date-label.nii.gz files + a
  TADPOLE-ish CSV with PTID/EXAMDATE/LABEL + mixed-type columns
  (pic_table_loader.py:50,63 layout)

Volumes are smooth random blobs (gaussian bumps), positive-valued like
real MRI intensities so adaptive_normal behaves realistically.
"""

from __future__ import annotations

import csv
import os
from os.path import join

import numpy as np

from gfe_mamba_torch.data.nifti import save_nifti


def _blob_volume(rng: np.random.Generator, shape) -> np.ndarray:
    """Smooth positive volume: a few gaussian bumps on a ramp."""
    coords = np.stack(np.meshgrid(
        *[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    vol = np.zeros(shape, np.float32)
    for _ in range(4):
        center = rng.uniform(-0.6, 0.6, size=3)
        width = rng.uniform(0.2, 0.5)
        d2 = sum((coords[i] - center[i]) ** 2 for i in range(3))
        vol += rng.uniform(200, 1000) * np.exp(-d2 / width ** 2)
    return vol.astype(np.float32)


def make_mri2pet_tree(root: str, n_subjects: int = 4,
                      shape=(24, 24, 16), seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for i in range(n_subjects):
        sub = join(root, f"subject_{i:03d}")
        os.makedirs(sub, exist_ok=True)
        mri = _blob_volume(rng, shape)
        pet = np.clip(mri / mri.max() * 2.0
                      + rng.normal(0, 0.05, shape), 0, 2).astype(np.float32)
        save_nifti(join(sub, "mri.nii.gz"), mri)
        save_nifti(join(sub, "pet.nii.gz"), pet)
    return root


def make_classify_tree(root: str, n_items: int = 6, shape=(24, 24, 16),
                       n_extra_rows: int = 4, seed: int = 0):
    """Returns (volume_dir, csv_path)."""
    rng = np.random.default_rng(seed)
    vol_dir = join(root, "volumes")
    os.makedirs(vol_dir, exist_ok=True)
    rows = []
    for i in range(n_items):
        ptid = f"{i:03d}_S_{1000 + i}"
        label = int(rng.integers(0, 2))
        day = int(rng.integers(1, 28))
        date = f"2006-03-{day:02d}"
        fname = f"{ptid}-2006_03_{day:02d}_12_00_00.0-{label}.nii.gz"
        save_nifti(join(vol_dir, fname), _blob_volume(rng, shape))
        rows.append({
            "PTID": ptid, "EXAMDATE": date, "LABEL": label,
            "RID": i, "SITE": 1,                      # dropped columns
            "AGE": float(rng.uniform(60, 90)),
            "MMSE": float(rng.uniform(20, 30)),
            "ADAS13": float(rng.uniform(5, 40)),
            "APOE4": int(rng.integers(0, 3)),
            "PTGENDER": str(rng.choice(["Male", "Female"])),  # categorical
            "PTMARRY": str(rng.choice(["Married", "Widowed",
                                       "Never married"])),
            "DX_bl": str(rng.choice(["LMCI", "EMCI"])),  # *bl* -> dropped
        })
    # distractor rows with mismatched dates/labels
    for i in range(n_extra_rows):
        rows.append({
            "PTID": f"{i:03d}_S_{1000 + i}", "EXAMDATE": "2009-01-01",
            "LABEL": int(rng.integers(0, 2)), "RID": 100 + i, "SITE": 2,
            "AGE": 70.0, "MMSE": 25.0, "ADAS13": 20.0, "APOE4": 1,
            "PTGENDER": "Male", "PTMARRY": "Married", "DX_bl": "LMCI",
        })
    csv_path = join(root, "table.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return vol_dir, csv_path
