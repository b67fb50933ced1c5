"""The segmentation prediction entry point (counterpart of
``seg_predict.py``; reference pytorch3dunet/predict.py): batched
sliding-window inference with a mirror halo and overlap-normalized
assembly, one gzip HDF5 file of predictions per input.

    python -m gfe_mamba_torch.cli.seg_predict --config <yaml> \
        [--override dotted.key=value ...] [--device cpu]

``model_path`` names a checkpoint of the port's trainer
(``segmentation/trainer.py``); each input ``<name>.h5`` of
``loaders.test.file_paths`` gets ``<name>_predictions.h5`` beside it.
The forward runs in f32 on the GPU (TF32 off) unless ``--device cpu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.cli.seg_train import parse_args
from gfe_mamba_torch.config import load_nested_config
from gfe_mamba_torch.data import h5
from gfe_mamba_torch.models.unet3d import get_model
from gfe_mamba_torch.segmentation.hdf5 import (save_predictions_h5,
                                               traverse_h5_paths)
from gfe_mamba_torch.segmentation.predictor import sliding_window_predict
from gfe_mamba_torch.training.checkpoint import Checkpointer


def main(args) -> list[str]:
    """Returns the files written."""
    config = load_nested_config(args.config, args.override)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    model = get_model(config["model"])
    payload = Checkpointer(os.path.dirname(config["model_path"])).restore(
        os.path.basename(config["model_path"]), map_location="cpu")
    model.load_state_dict(payload["model"])
    model.to(device).eval()

    loaders_cfg = config["loaders"]
    test_cfg = loaders_cfg["test"]
    patch = tuple(test_cfg["slice_builder"]["patch_shape"])
    stride = tuple(test_cfg["slice_builder"]["stride_shape"])
    halo = tuple(test_cfg["slice_builder"].get("halo_shape", (0, 0, 0)))

    @torch.no_grad()
    def predict(x: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(x).to(device)).float().cpu().numpy()

    written = []
    for path in traverse_h5_paths(test_cfg["file_paths"]):
        raw = h5.read(path, loaders_cfg.get("raw_internal_path", "raw"))
        raw = np.moveaxis(raw, 0, -1) if raw.ndim == 4 else raw[..., None]
        prediction = sliding_window_predict(
            predict, raw.astype(np.float32), patch, stride, halo_shape=halo,
            out_channels=config["model"]["out_channels"],
            batch_size=test_cfg.get("batch_size", 4))
        out_path = os.path.splitext(path)[0] + "_predictions.h5"
        save_predictions_h5(out_path, prediction)
        print(f"{path} -> {out_path} {prediction.shape}")
        written.append(out_path)
    return written


if __name__ == "__main__":
    main(parse_args())
