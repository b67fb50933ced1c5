"""The segmentation training entry point (counterpart of ``seg_train.py``;
reference pytorch3dunet/train.py): seeded, driven by a nested YAML config
(model / loss / eval_metric / optimizer / lr_scheduler / trainer /
loaders sections), resumable.

    python -m gfe_mamba_torch.cli.seg_train --config <yaml> \
        [--override dotted.key=value ...] [--device cpu]

The model trains in f32 on the GPU (cuDNN's convs with TF32 off, as the
JAX trainer runs f32) unless ``--device cpu``.  The YAML is read without
PyYAML (``config.py::load_nested_config``), the HDF5 volumes without
h5py (``data/h5.py``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gfe_mamba_torch.config import load_nested_config
from gfe_mamba_torch.data.loader import DataLoader
from gfe_mamba_torch.models.unet3d import get_model
from gfe_mamba_torch.segmentation.hdf5 import HDF5Dataset, traverse_h5_paths
from gfe_mamba_torch.segmentation.trainer import UNetTrainer


class Concat:
    """Several datasets end to end."""

    def __init__(self, parts):
        self.parts = parts
        self.offsets = np.cumsum([0] + [len(p) for p in parts])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, i):
        j = int(np.searchsorted(self.offsets, i, "right")) - 1
        return self.parts[j][i - int(self.offsets[j])]


def build_loaders(config: dict):
    """The train (shuffled) and val loaders of ``config["loaders"]``, as
    the JAX script builds them."""
    loaders_cfg = config["loaders"]
    loaders = {}
    for phase in ("train", "val"):
        phase_cfg = loaders_cfg[phase]
        parts = [HDF5Dataset(
            p, phase, phase_cfg["slice_builder"],
            phase_cfg.get("transformer"),
            raw_internal_path=loaders_cfg.get("raw_internal_path", "raw"),
            label_internal_path=loaders_cfg.get("label_internal_path",
                                                "label"),
            lazy=loaders_cfg.get("dataset", "standard") == "lazy",
        ) for p in traverse_h5_paths(phase_cfg["file_paths"])]
        loaders[phase] = DataLoader(
            Concat(parts), loaders_cfg.get("batch_size", 1),
            shuffle=phase == "train",
            num_workers=loaders_cfg.get("num_workers", 0))
    return loaders["train"], loaders["val"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--override", nargs="*", default=[],
                        help="dotted.key=value config overrides")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU when omitted (raises "
                             "without one), 'cpu' for the plain path")
    return parser.parse_args(argv)


def main(args) -> UNetTrainer:
    config = load_nested_config(args.config, args.override)
    seed = config.get("manual_seed", 0)
    np.random.seed(seed)
    torch.backends.cudnn.allow_tf32 = False

    model = get_model(config["model"], seed=seed)
    trainer = UNetTrainer(model, config, config["trainer"]["checkpoint_dir"],
                          device=args.device)
    train_loader, val_loader = build_loaders(config)
    # the JAX script draws one batch to size its init, which starts an
    # epoch of the loader; the port needs no sample but keeps the epoch
    # count, so every later epoch shuffles as the script's does (random
    # transforms draw as items load, and the script's sample loads a
    # thread-timed number of batches ahead: those draws are not kept)
    train_loader.epoch += 1
    trainer.init_state(seed)
    if config["trainer"].get("resume"):
        trainer.resume()
    trainer.fit(train_loader, val_loader)
    return trainer


if __name__ == "__main__":
    main(parse_args())
