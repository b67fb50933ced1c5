"""Stage-2 multimodal Mamba classifier training, the port's counterpart
of ``classify_mamba.py``:

    python -m gfe_mamba_torch.cli.classify_mamba \\
        --config_path configs/classify_mamba_config.yaml [--device cpu]

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
(zero-width categorical and numerical inputs).  One process:
``WORLD_SIZE > 1`` and ``async_ckpt: true`` raise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.cli.common import (build_pipeline, check_single_process,
                                        evaluate, load_weights,
                                        parse_args, table_inputs)
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import classi_dataloader
from gfe_mamba_torch.training.checkpoint import BestTracker, save_params_npz
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.training.resilience import StrikeCounter
from gfe_mamba_torch.utils.experiment import (ExperimentDir,
                                              count_parameters,
                                              save_plot_data)


def build_loaders(cf: dict):
    img_sz = tuple(cf["img_sz"])
    common = dict(days_threshold=cf.get("days_threshold", -1),
                  num_workers=cf.get("num_workers", 2))
    train_loader = classi_dataloader(
        cf["train_path"], img_sz, cf["train_bc"], cf["table_path"],
        shuffle=True, seed=cf.get("seed", 0), **common)
    val_loader = classi_dataloader(
        cf["eval_path"], img_sz, cf["eval_bc"], cf["table_path"],
        shuffle=False, **common)
    return train_loader, val_loader


def main(args) -> dict:
    """Train; returns the trainer, the run directory, each step's wall
    milliseconds, the loaders and the last validation."""
    cf = load_config(args.config_path)
    check_single_process(cf)
    device = resolve_device(args.device)
    exp = ExperimentDir(args.config_path,
                        cf.get("project_dir", "weights/classifier"),
                        is_debug=cf.get("is_debug", False),
                        log_with=cf.get("log_with", ""),
                        program_name="classify_mamba")
    train_loader, val_loader = build_loaders(cf)
    dataset = train_loader.dataset
    model = build_pipeline(cf, dataset, device)
    trainer = ClassifyTrainer(
        model, lr=cf.get("lr", 1e-4), grad_clip=cf.get("grad_clip", 1.0),
        mixed_precision=cf.get("mixed_precision", "bf16"), device=device,
        seed=cf.get("seed", 0), init=cf.get("cls_init", "torch"))
    if cf.get("gan_ckpt"):
        load_weights(cf["gan_ckpt"], model.generator)
        print(f"loaded Stage-1 generator from {cf['gan_ckpt']}", flush=True)

    exp.write(f"The size of model: {count_parameters(model)} \n")
    if not exp.is_debug and dataset.table is not None:
        with open(exp.path("table_preprocessor.json"), "w") as f:
            f.write(dataset.preprocessor.to_json())

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
            if global_step % cf.get("log_every", 10) == 0:
                exp.log_scalars(logs, global_step)
                print(f"epoch {epoch + 1}: " +
                      " ".join(f"{k}={v:.4f}" for k, v in logs.items()),
                      flush=True)
            global_step += 1

        last = epoch == num_epochs - 1
        if (epoch + 1) % cf["val_inter"] == 0 or last:
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
        if not exp.is_debug and ((epoch + 1) % cf["save_inter"] == 0
                                 or last):
            save_params_npz(exp.path("model_current", "model_current.npz"),
                            model.combiner)
            save_params_npz(exp.path("model_current",
                                     "ft_model_current.npz"),
                            model.classifier)
            print("Saved model", flush=True)
    exp.close()
    return dict(trainer=trainer, exp_dir=exp.root, step_ms=step_ms,
                train_loader=train_loader, val_loader=val_loader,
                validation=last_val)


if __name__ == "__main__":
    main(parse_args("Stage-2 classifier training (PyTorch port)",
                    "configs/classify_mamba_config.yaml"))
