"""What the three entry points share: the device argument, the config
keys that size the generator, the pipeline built from a dataset, the
table inputs of a batch and the checkpoint formats a generator loads
from."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gfe_mamba_torch.training.checkpoint import load_params_npz

GENERATOR_KEYS = ("fold_factor", "vit_patch_size", "vit_dim", "vit_depth",
                  "vit_heads", "vit_mlp_dim")


def parse_args(description: str, default_config: str,
               argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config_path", type=str, default=default_config)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU when omitted (raises "
                             "without one), 'cpu' for the plain path")
    return parser.parse_args(argv)


def check_single_process(cf: dict) -> None:
    """The port runs one process; data parallelism and async checkpoints
    are not ported yet, and neither is ignored."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process training is not ported "
            f"yet (ROADMAP A.6)")
    if cf.get("async_ckpt", False):
        raise NotImplementedError(
            "async_ckpt: true: asynchronous checkpointing is not ported "
            "yet (ROADMAP A.7)")


def generator_kwargs(cf: dict, remat_default: bool) -> dict:
    return dict(img_size=tuple(cf["img_sz"]),
                f_maps=tuple(cf.get("f_maps", (64, 128, 256))),
                remat=cf.get("remat", remat_default),
                **{k: cf[k] for k in GENERATOR_KEYS if k in cf})


def build_pipeline(cf: dict, dataset, device):
    """``build_gfe_mamba`` from the classify config keys, f32 weights
    drawn from ``seed`` under the torch law."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    return build_gfe_mamba(
        categories=dataset.num_cat, num_continuous=dataset.num_cont,
        dim=cf["dim"], depth=cf["depth"], heads=cf["heads"],
        dim_out=cf.get("dim_out", 1), seq_length=cf.get("seq_length", 4),
        mixer=cf.get("mixer", "mamba"), seed=cf.get("seed", 0),
        device=device, **generator_kwargs(cf, remat_default=False))


def load_weights(path: str, module: torch.nn.Module) -> None:
    """A reference ``.pt``/``.pth`` state_dict (the port keeps the
    reference's parameter names) or an npz of either package."""
    if path.endswith((".pt", ".pth")):
        state = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        module.load_state_dict(state)
    else:
        load_params_npz(path, module)


def table_inputs(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cate_x, conti_x)`` of a batch; zero-width in the tableless mode
    (``table_path: ''``)."""
    n = len(batch["label"])
    if "cate_x" not in batch:
        return (torch.zeros((n, 0), dtype=torch.int32),
                torch.zeros((n, 0), dtype=torch.float32))
    return (torch.from_numpy(np.asarray(batch["cate_x"])),
            torch.from_numpy(np.asarray(batch["conti_x"])))


def evaluate(trainer, loader) -> dict:
    """``ClassifyTrainer.eval_step`` over ``loader``: the summed confusion
    counts, the mean loss per item, every probability and target."""
    counts, losses, total = None, 0.0, 0
    preds, targets = [], []
    for batch in loader:
        cate, conti = table_inputs(batch)
        probs, loss, c = trainer.eval_step(
            torch.from_numpy(batch["image"]), cate, conti,
            torch.from_numpy(np.asarray(batch["label"])))
        counts = c if counts is None else counts + c
        n = len(batch["label"])
        losses += float(loss) * n
        total += n
        preds.append(probs.float().cpu().numpy())
        targets.append(np.asarray(batch["label"]))
    return dict(counts=counts, val_loss=losses / max(total, 1),
                metrics=trainer.metrics(counts),
                preds=np.concatenate(preds), targets=np.concatenate(targets))
