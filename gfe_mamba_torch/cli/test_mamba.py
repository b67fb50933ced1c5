"""Full-pipeline evaluation (Acc/Recall/F1/Pre/MCC/Val_loss), the port's
counterpart of ``test_mamba.py``:

    python -m gfe_mamba_torch.cli.test_mamba \\
        --config_path configs/classify_mamba_config_test.yaml [--device cpu]

``gan_ckpt`` is the Stage-1 generator, ``pth_dir`` the Stage-2 directory
(``model_best`` or ``model_current``) and ``use_best`` picks
``best_model``/``best_ft_model`` or ``model_current``/
``ft_model_current``: reference ``.pth`` state_dicts when the combiner's
is there, else npz files of either package.  Prints the metrics as the
JAX script does and writes them to the run log.
"""

from __future__ import annotations

import os
from os.path import join

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.cli.common import (build_pipeline, evaluate,
                                        load_weights, parse_args)
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import classi_dataloader
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.utils.experiment import ExperimentDir


def stage2_paths(cf: dict) -> tuple[str, str]:
    """The combiner's and the classifier's checkpoint path under
    ``pth_dir``, without extension."""
    use_best = cf.get("use_best", False)
    prefix = "best_" if use_best else ""
    suffix = "" if use_best else "_current"
    return (join(cf["pth_dir"], f"{prefix}model{suffix}"),
            join(cf["pth_dir"], f"{prefix}ft_model{suffix}"))


def main(args) -> dict:
    """Evaluate; returns the metrics, the loss and the model."""
    cf = load_config(args.config_path)
    device = resolve_device(args.device)
    exp = ExperimentDir(args.config_path,
                        cf.get("project_dir", "weights/classifier"),
                        is_debug=cf.get("is_debug", True),
                        program_name="test_mamba")
    val_loader = classi_dataloader(
        cf["eval_path"], tuple(cf["img_sz"]), cf["eval_bc"],
        cf["table_path"], shuffle=False,
        days_threshold=cf.get("days_threshold", -1),
        num_workers=cf.get("num_workers", 2))
    model = build_pipeline(cf, val_loader.dataset, device)
    if cf.get("gan_ckpt"):
        load_weights(cf["gan_ckpt"], model.generator)
    if cf.get("pth_dir"):
        comb_path, cls_path = stage2_paths(cf)
        ext = ".pth" if os.path.exists(comb_path + ".pth") else ".npz"
        load_weights(comb_path + ext, model.combiner)
        load_weights(cls_path + ext, model.classifier)
    trainer = ClassifyTrainer(model, device=device)

    result = evaluate(trainer, val_loader)
    m, loss = result["metrics"], result["val_loss"]
    print(f"Acc: {m['accuracy'] * 100: .4f}")
    print(f"Recall: {m['recall']: .4f}")
    print(f"F1: {m['f1']:.4f}")
    print(f"Pre: {m['precision']:.4f}")
    print(f"MCC: {m['mcc']:.4f}")
    print(f"Val_loss: {loss: .4f} \n", flush=True)
    exp.write(f"Acc: {m['accuracy'] * 100: .4f}% "
              f"Recall: {m['recall']: .4f} F1: {m['f1']:.4f} "
              f"Pre: {m['precision']:.4f} MCC: {m['mcc']:.4f} "
              f"Val_loss: {loss: .4f} \n")
    exp.close()
    return dict(metrics=m, val_loss=loss, counts=result["counts"],
                model=model)


if __name__ == "__main__":
    main(parse_args("GFE-Mamba evaluation (PyTorch port)",
                    "configs/classify_mamba_config_test.yaml"))
