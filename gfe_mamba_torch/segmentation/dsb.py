"""The DSB2018-style 2D nuclei dataset (counterpart of
``gfe_mamba_tpu/segmentation/dsb.py``; reference datasets/dsb.py:32).

Layout: ``<root>/images/*.png`` and ``<root>/masks/*.png`` with matching
stems.  Images load as greyscale f32 in [0, 1], channels-last ``(H, W,
1)``; masks as {0, 1}.  The PNGs are read by ``data/png.py`` (PIL's
greyscale conversion, no PIL).  A transform config builds twin pipelines
of ``segmentation/transforms.py`` from one seed, so the random spatial
transforms of an image and its mask agree.
"""

from __future__ import annotations

import os
from glob import glob
from os.path import basename, join, splitext

import numpy as np

from gfe_mamba_torch.data.png import load_grey
from gfe_mamba_torch.segmentation.transforms import build_transforms


def _load_png(path: str) -> np.ndarray:
    return load_grey(path).astype(np.float32) / 255.0


class DSB2018Dataset:
    def __init__(self, root: str, phase: str = "train",
                 transformer_config=None, seed: int = 47):
        self.phase = phase
        self.images = sorted(glob(join(root, "images", "*.png")))
        self.masks_dir = join(root, "masks")
        self.transform = self.mask_transform = None
        if transformer_config:
            self.transform = build_transforms(transformer_config, seed)
            self.mask_transform = build_transforms(transformer_config, seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> dict:
        """``{"raw", "name"}``, and ``"label"`` outside the test phase
        where the image has a mask."""
        img_path = self.images[index]
        item = {"raw": _load_png(img_path)[..., None],
                "name": basename(img_path)}
        if self.phase != "test":
            mask_path = join(self.masks_dir,
                             splitext(basename(img_path))[0] + ".png")
            if os.path.exists(mask_path):
                mask = (_load_png(mask_path) > 0.5).astype(np.float32)
                item["label"] = mask[..., None]
        if self.transform is not None:
            item["raw"] = self.transform(item["raw"])
            if "label" in item:
                item["label"] = self.mask_transform(item["label"])
        return item
