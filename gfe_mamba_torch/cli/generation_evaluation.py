"""Score a trained Stage-1 generator: side-by-side MRI | PET |
reconstruction slice grids, one PNG per batch, and the mean PSNR and
MSE over the batches (counterpart of ``tools/generation_evaluation.py``;
reference utils/generation_evaluation_vit.py:34-42).

    python -m gfe_mamba_torch.cli.generation_evaluation \
        --config_path <gan yaml> --ckpt <model.npz> \
        [--num_batches 20] [--out_dir gen_eval] [--device cpu]

The generator is built from the config's keys (``img_sz``, ``f_maps``
and the ViT keys) and takes the checkpoint's weights (an npz of either
package, or a reference ``.pt``); it runs in f32, as the JAX tool's
``jax.jit(generator.apply)`` on f32 parameters does, so on the card all
of its 3x3x3 convs run K1's f32 variant.  It prints
``batches=... PSNR=... MSE=...`` in the JAX tool's format.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.cli.common import generator_kwargs, load_weights
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import form_dataloader
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.segmentation.metrics import psnr
from gfe_mamba_torch.utils.experiment import save_volume_grid


def main(args) -> dict:
    """Evaluate; returns each batch's PSNR, MSE and seconds (the host
    clock around the batch's forward and its two metric reads)."""
    cf = load_config(args.config_path)
    device = resolve_device(args.device)
    loader = form_dataloader(cf["eval_path"], tuple(cf["img_sz"]),
                             cf.get("eval_bc", 1), shuffle=False)
    generator = build_generator(device=device,
                                **generator_kwargs(cf, remat_default=False))
    load_weights(args.ckpt, generator)
    generator.eval()

    os.makedirs(args.out_dir, exist_ok=True)
    psnrs, mses, seconds = [], [], []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if i >= args.num_batches:
                break
            t = time.perf_counter()
            mri = torch.from_numpy(batch["image"]).to(device)
            pet = torch.from_numpy(batch["label"]).to(device)
            recon = generator(mri)
            psnrs.append(float(psnr(recon, pet)))
            mses.append(float(torch.mean((recon - pet) ** 2)))
            seconds.append(time.perf_counter() - t)
            panel = np.concatenate(
                [batch["image"], batch["label"], recon.cpu().numpy()],
                axis=1)
            save_volume_grid(panel, os.path.join(args.out_dir, f"{i + 1}.png"))
    print(f"batches={len(psnrs)} PSNR={np.mean(psnrs):.3f} "
          f"MSE={np.mean(mses):.6f}")
    return dict(psnr=psnrs, mse=mses, seconds=seconds)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--num_batches", type=int, default=20)
    parser.add_argument("--out_dir", default="gen_eval")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU when omitted (raises "
                             "without one), 'cpu' for the plain path")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
