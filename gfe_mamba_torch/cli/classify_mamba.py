"""Stage-2 multimodal Mamba classifier training, the port's counterpart
of ``classify_mamba.py``:

    python -m gfe_mamba_torch.cli.classify_mamba \\
        --config_path configs/classify_mamba_config.yaml [--device cpu]
    torchrun --nproc_per_node N -m gfe_mamba_torch.cli.classify_mamba ...

The same YAML keys and the same files; ``mixer`` picks the classifier
(``mamba``, ``jamba`` or ``transformer``), ``attn_dropout`` and
``ff_dropout`` its dropout rates.  ``gan_ckpt`` is the Stage-1
generator: a ``model.npz`` of either package or a reference ``.pt/.pth``
state_dict (the port's parameter names are the reference's); ``cls_init``
is the init law of step 0 (``torch`` or ``flax``).  Each validation
prints and logs Acc/Recall/F1/Val_loss and, at a new best (accuracy,
then lower loss), writes ``model_best/best_model.npz`` (combiner) and
``best_ft_model.npz`` (classifier); each save writes
``model_current/model_current.npz`` and ``ft_model_current.npz``; all in
the JAX package's npz keys.  ``table_preprocessor.json`` holds the
fitted table transform.  ``table_path: ''`` trains without the table
(zero-width categorical and numerical inputs).  ``async_ckpt: true``
also keeps the combiner, the classifier (JAX keys) and the epoch at each
save in ``model_save/step_<epoch>`` through an ``AsyncCheckpointManager``
(``ckpt_keep`` newest, ``ckpt_keep_best`` by validation accuracy).

Under ``torchrun`` (``cli/common.py``) every rank trains on its rows of
each global batch of ``train_bc``; rank 0 alone validates and writes
(npz, logs, the table transform) while the others wait at a barrier.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gfe_mamba_torch.cli.common import (build_pipeline, evaluate,
                                        experiment_dir, load_weights,
                                        parse_args, start_processes,
                                        table_inputs, wait_for_main)
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import classi_dataloader
from gfe_mamba_torch.parallel import multihost
from gfe_mamba_torch.parallel.mesh import replicate
from gfe_mamba_torch.training.checkpoint import (AsyncCheckpointManager,
                                                 BestTracker,
                                                 save_params_npz)
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.training.resilience import StrikeCounter
from gfe_mamba_torch.utils.convert import jax_tree_from_state_dict
from gfe_mamba_torch.utils.experiment import count_parameters, save_plot_data


def build_loaders(cf: dict, train_bc: int | None = None,
                  process_shard=None):
    """The train loader (``train_bc`` rows per process, default the
    config's, and its ``process_shard``) and the validation loader."""
    img_sz = tuple(cf["img_sz"])
    common = dict(days_threshold=cf.get("days_threshold", -1),
                  num_workers=cf.get("num_workers", 2))
    train_loader = classi_dataloader(
        cf["train_path"], img_sz, train_bc or cf["train_bc"],
        cf["table_path"], shuffle=True, seed=cf.get("seed", 0),
        process_shard=process_shard, **common)
    val_loader = classi_dataloader(
        cf["eval_path"], img_sz, cf["eval_bc"], cf["table_path"],
        shuffle=False, **common)
    return train_loader, val_loader


def main(args) -> dict:
    """Train; returns the trainer, the run directory, each step's wall
    milliseconds, the loaders and the last validation."""
    cf = load_config(args.config_path)
    device, mesh, local_bc, shard = start_processes(args, cf)
    main_rank = multihost.is_main_process()
    exp = experiment_dir(args.config_path, cf, "weights/classifier",
                         "classify_mamba")
    train_loader, val_loader = build_loaders(cf, local_bc, shard)
    dataset = train_loader.dataset
    model = build_pipeline(cf, dataset, device)
    trainer = ClassifyTrainer(
        model, lr=cf.get("lr", 1e-4), grad_clip=cf.get("grad_clip", 1.0),
        mixed_precision=cf.get("mixed_precision", "bf16"), device=device,
        seed=cf.get("seed", 0), init=cf.get("cls_init", "torch"), mesh=mesh)
    if cf.get("gan_ckpt"):
        load_weights(cf["gan_ckpt"], model.generator)
        if main_rank:
            print(f"loaded Stage-1 generator from {cf['gan_ckpt']}",
                  flush=True)
    replicate(model)

    exp.write(f"The size of model: {count_parameters(model)} \n")
    if main_rank and not exp.is_debug and dataset.table is not None:
        with open(exp.path("table_preprocessor.json"), "w") as f:
            f.write(dataset.preprocessor.to_json())
    ckpt = AsyncCheckpointManager(
        exp.path("model_save"), max_to_keep=cf.get("ckpt_keep", 3),
        keep_best=cf.get("ckpt_keep_best", 1)) \
        if cf.get("async_ckpt", False) else None

    best = BestTracker()
    global_step = 0
    num_epochs = cf["num_epochs"]
    strikes = StrikeCounter(max_strikes=10)
    step_ms, last_val = [], None
    for epoch in range(num_epochs):
        for batch in train_loader:
            cate, conti = table_inputs(batch)
            t = time.perf_counter()
            logs = trainer.train_step(
                torch.from_numpy(batch["image"]), cate, conti,
                torch.from_numpy(np.asarray(batch["label"])))
            step_ms.append((time.perf_counter() - t) * 1e3)
            strikes.update(logs.pop("skipped"))
            if global_step % cf.get("log_every", 10) == 0 and main_rank:
                exp.log_scalars(logs, global_step)
                print(f"epoch {epoch + 1}: " +
                      " ".join(f"{k}={v:.4f}" for k, v in logs.items()),
                      flush=True)
            global_step += 1

        last = epoch == num_epochs - 1
        do_val = (epoch + 1) % cf["val_inter"] == 0 or last
        do_save = not exp.is_debug and ((epoch + 1) % cf["save_inter"] == 0
                                        or last)
        accuracy = None
        if do_val and main_rank:
            last_val = evaluate(trainer, val_loader)
            m, val_loss = last_val["metrics"], last_val["val_loss"]
            if not exp.is_debug:
                save_plot_data(epoch + 1, last_val["preds"],
                               last_val["targets"], exp.path("val_data"))
            accuracy = m["accuracy"] * 100
            line = (f"Epoch {epoch + 1}: Acc: {accuracy: .4f}% "
                    f"Recall: {m['recall']: .4f} F1: {m['f1']:.4f} "
                    f"Val_loss: {val_loss: .4f} \n")
            print(line, end="", flush=True)
            exp.write(line)
            exp.log_scalars({"accuracy": accuracy, "recall": m["recall"],
                             "f1": m["f1"], "validation_loss": val_loss},
                            global_step)
            if not exp.is_debug and best.is_better(accuracy, val_loss):
                save_params_npz(exp.path("model_best", "best_model.npz"),
                                model.combiner)
                save_params_npz(exp.path("model_best", "best_ft_model.npz"),
                                model.classifier)
                print("Saved best model", flush=True)
        if do_save:
            # collective: every rank gathers, rank 0 writes
            parts = {p: multihost.host_local(getattr(model, p))
                     for p in ("combiner", "classifier")}
            if main_rank:
                save_params_npz(exp.path("model_current",
                                         "model_current.npz"),
                                parts["combiner"])
                save_params_npz(exp.path("model_current",
                                         "ft_model_current.npz"),
                                parts["classifier"])
                print("Saved model", flush=True)
            if ckpt is not None:
                ckpt.save(epoch + 1, {
                    **{p: jax_tree_from_state_dict(state)
                       for p, state in parts.items()}, "epoch": epoch},
                    metric=accuracy)
        if do_val or do_save:
            wait_for_main()
    if ckpt is not None:
        ckpt.close()
    exp.close()
    return dict(trainer=trainer, exp_dir=exp.root, step_ms=step_ms,
                train_loader=train_loader, val_loader=val_loader,
                validation=last_val)


if __name__ == "__main__":
    main(parse_args("Stage-2 classifier training (PyTorch port)",
                    "configs/classify_mamba_config.yaml"))
    multihost.shutdown()
