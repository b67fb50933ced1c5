"""Experiment management: run dirs, logging, visualization dumps
(counterpart of ``gfe_mamba_tpu/utils/experiment.py``).

Re-implements utils/common.py: timestamped experiment directories with
config snapshots (copy_yaml_to_folder_auto, common.py:99-124),
``count_parameters`` (common.py:13), prediction dumps per epoch
(save_plot_data, common.py:16-26) and the MRI/PET slice-grid PNGs
(see_mri_pet, common.py:42-53) used for validation visualization
(main_gan_vit.py:113-116).  TensorBoard scalars go through
tensorboardX when available (the reference logs via Accelerate
trackers, main_gan_vit.py:52-53,102).  The PNG is written by
``data/png.py``: an 8-bit greyscale image.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import time
from datetime import datetime
from os.path import basename, join, splitext

import numpy as np

from gfe_mamba_torch.data.png import write_png


def count_parameters(module) -> int:
    """Elements of every parameter of ``module`` (a ``torch.nn.Module``)."""
    return sum(p.numel() for p in module.parameters())


def make_experiment_dir(config_path: str, folder: str,
                        program_name: str | None = None) -> str:
    """exp_<MMDDHHMMSS>_<program> dir with a config snapshot
    (common.py:99-124)."""
    stamp = datetime.fromtimestamp(time.time()).strftime("%m%d%H%M%S")
    if program_name is None:
        program_name = splitext(basename(sys.argv[0]))[0]
    run_dir = join(folder, f"exp_{stamp}_{program_name}")
    os.makedirs(run_dir, exist_ok=True)
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, join(run_dir, basename(config_path)))
    return run_dir


class ExperimentDir:
    """Run directory + text/TensorBoard logging + checkpoint subdirs.
    ``writer=False`` (a rank other than 0 of a multi-process run) makes
    and writes nothing; its ``root`` is set from rank 0's."""

    def __init__(self, config_path: str, project_dir: str,
                 is_debug: bool = False, log_with: str = "",
                 program_name: str | None = None, writer: bool = True):
        self.is_debug = is_debug
        self.log_file = self.writer = None
        if not writer:
            self.root = "." if is_debug else None
            return
        if is_debug:
            self.root = "."
            self.log_file = open("debug.txt", "w")
        else:
            self.root = make_experiment_dir(config_path, project_dir,
                                            program_name)
            self.log_file = open(join(self.root, "train_loss.txt"), "w")
            for sub in ("model_save", "model_best", "model_current",
                        "val_data", "results_save"):
                os.makedirs(join(self.root, sub), exist_ok=True)
        if log_with and not is_debug:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(join(self.root, "tb"))
            except ImportError:
                pass

    def path(self, *parts: str) -> str:
        return join(self.root, *parts)

    def write(self, text: str) -> None:
        if self.log_file is not None:
            self.log_file.write(text)
            self.log_file.flush()

    def log_scalars(self, logs: dict, step: int) -> None:
        if self.writer is not None:
            for key, value in logs.items():
                self.writer.add_scalar(key, float(value), step)

    def close(self) -> None:
        if self.log_file is not None:
            self.log_file.close()
        if self.writer is not None:
            self.writer.close()


def save_plot_data(epoch: int, predictions, targets, parent_dir: str) -> None:
    """Per-epoch prediction dump (common.py:16-26) as npz."""
    np.savez(join(parent_dir, f"epoch_{epoch}_data.npz"),
             epoch=epoch, predictions=np.asarray(predictions),
             targets=np.asarray(targets))


def volume_grid(volume: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Depth-slice grid image of one channels-last volume (H, W, D[, C])
    (see_mri_pet, common.py:42-53): slices tile into a rows x cols
    mosaic, [-1,1] -> [0,1]."""
    vol = np.asarray(volume)
    if vol.ndim == 5:
        vol = vol[0]
    if vol.ndim == 4:
        vol = vol[..., 0]
    h, w, d = vol.shape
    cols = 8
    rows = math.ceil(d / cols)
    grid = np.zeros((rows * h, cols * w), vol.dtype)
    for i in range(d):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = vol[:, :, i]
    if normalize:
        grid = (grid + 1.0) / 2.0
    return np.clip(grid, 0.0, 1.0)


def save_volume_grid(volume, path: str, normalize: bool = True) -> None:
    grid = (volume_grid(volume, normalize) * 255).astype(np.uint8)
    write_png(path, grid)
