"""What the entry points share: the device argument, the process group
of a multi-process run and the per-process batch, the run directory
(written by rank 0 only), the config keys that size the generator, the
pipeline built from a dataset, the table inputs of a batch and the
checkpoint formats a generator loads from.

The two training CLIs run under a launcher as they run alone:

    torchrun --nproc_per_node 4 -m gfe_mamba_torch.cli.main_gan_vit \
        --config_path <yaml>

Each process takes ``cuda:LOCAL_RANK`` (NCCL; ``--device cpu``: gloo),
``train_bc / WORLD_SIZE`` rows of every global batch (``train_bc`` must
divide) and averages its gradients with the others'.  A process group
that fails to form raises; nothing falls back to one process.  The
other ranks wait at most ``WAIT_FOR_MAIN_S`` while rank 0 validates and
writes."""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from gfe_mamba_torch.parallel import multihost
from gfe_mamba_torch.parallel.mesh import make_mesh
from gfe_mamba_torch.training.checkpoint import load_params_npz
from gfe_mamba_torch.utils.experiment import ExperimentDir

# how long the other ranks wait while rank 0 validates or writes
WAIT_FOR_MAIN_S = 3600.0

# the JAX CLIs' generator keys
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


def start_processes(args, cf: dict):
    """Join the launcher's process group (``parallel/multihost.py``; a
    no-op alone) and lay every rank on the data axis, as the JAX CLIs'
    ``make_mesh()`` does.  Returns ``(device, mesh, local train batch,
    loader process_shard)``; ``mesh`` is None in a single process."""
    device = multihost.initialize(args.device)
    mesh = make_mesh() if dist.is_initialized() else None
    nproc = multihost.process_count()
    if cf["train_bc"] % nproc:
        raise ValueError(f"train_bc {cf['train_bc']} not divisible by "
                         f"{nproc} processes")
    shard = (multihost.process_index(), nproc) if nproc > 1 else None
    return device, mesh, cf["train_bc"] // nproc, shard


def experiment_dir(config_path: str, cf: dict, project_dir: str,
                   program_name: str) -> ExperimentDir:
    """The run directory: made and written by rank 0 only, its path
    broadcast to the other ranks."""
    exp = ExperimentDir(config_path, cf.get("project_dir", project_dir),
                        is_debug=cf.get("is_debug", False),
                        log_with=cf.get("log_with", ""),
                        program_name=program_name,
                        writer=multihost.is_main_process())
    if dist.is_initialized():
        root = [exp.root]
        dist.broadcast_object_list(root, 0)
        exp.root = root[0]
    return exp


def wait_for_main() -> None:
    """The other ranks wait here while rank 0 validates or writes (a
    barrier that raises after ``WAIT_FOR_MAIN_S``)."""
    multihost.barrier(WAIT_FOR_MAIN_S)


def generator_kwargs(cf: dict, remat_default: bool) -> dict:
    return dict(img_size=tuple(cf["img_sz"]),
                f_maps=tuple(cf.get("f_maps", (64, 128, 256))),
                remat=cf.get("remat", remat_default),
                **{k: cf[k] for k in GENERATOR_KEYS if k in cf})


def build_pipeline(cf: dict, dataset, device):
    """``build_gfe_mamba`` from the classify config keys (``mixer``,
    ``attn_dropout`` and ``ff_dropout`` among them), f32 weights drawn
    from ``seed`` under the torch law."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    return build_gfe_mamba(
        categories=dataset.num_cat, num_continuous=dataset.num_cont,
        dim=cf["dim"], depth=cf["depth"], heads=cf["heads"],
        dim_out=cf.get("dim_out", 1),
        attn_dropout=cf.get("attn_dropout", 0.1),
        ff_dropout=cf.get("ff_dropout", 0.1),
        seq_length=cf.get("seq_length", 4),
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
