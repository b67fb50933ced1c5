"""Stage-1 GAN-ViT training (MRI -> PET), the port's counterpart of
``main_gan_vit.py``:

    python -m gfe_mamba_torch.cli.main_gan_vit \\
        --config_path configs/main_gan_vit_config.yaml [--device cpu]

The same YAML keys and the same files: a run directory
``<project_dir>/exp_<stamp>_main_gan_vit`` with the config, the loss log,
``results_save/<epoch>/<i>.png`` validation panels (MRI | PET | recon)
and ``model_save/model.npz`` (the generator in the JAX package's npz keys,
so ``classify_mamba.py`` of either package loads it) beside
``model_save/state`` (both players' weights and the epoch).  Auto-resume
snapshots live in ``<project_dir>/autoresume_main_gan_vit`` (or
``resume_dir``): a restarted run with the same config restores the newest
(both players, both Adams, the dropout generator's state, the epoch) and
goes on at the next epoch.  One process: ``WORLD_SIZE > 1`` and
``async_ckpt: true`` raise.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.cli.common import (check_single_process,
                                        generator_kwargs, parse_args)
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import form_dataloader
from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.training.checkpoint import Checkpointer, save_params_npz
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.training.resilience import AutoResume, StrikeCounter
from gfe_mamba_torch.utils.experiment import ExperimentDir, save_volume_grid


def main(args) -> dict:
    """Train; returns the trainer, the run directory, each step's wall
    milliseconds and the train loader (its wait per batch)."""
    cf = load_config(args.config_path)
    check_single_process(cf)
    device = resolve_device(args.device)
    exp = ExperimentDir(args.config_path, cf.get("project_dir", "weights"),
                        is_debug=cf.get("is_debug", False),
                        log_with=cf.get("log_with", ""),
                        program_name="main_gan_vit")
    img_sz = tuple(cf["img_sz"])
    seed = cf.get("seed", 0)
    train_loader = form_dataloader(cf["train_path"], img_sz, cf["train_bc"],
                                   shuffle=True, seed=seed,
                                   num_workers=cf.get("num_workers", 2))
    val_loader = form_dataloader(cf["eval_path"], img_sz, cf["eval_bc"],
                                 shuffle=False,
                                 num_workers=cf.get("num_workers", 2))

    gen_kwargs = generator_kwargs(cf, remat_default=True)
    generator = build_generator(seed=seed, device=device, **gen_kwargs)
    discriminator = PatchDiscriminator(num_layers_d=3, num_channels=32)
    discriminator.reset_parameters(torch.Generator().manual_seed(seed + 1))
    trainer = GanTrainer(
        generator, discriminator,
        PerceptualLoss(fake_3d_ratio=0.25, seed=seed, device=device),
        lr_g=cf.get("lr_g", 1e-4), lr_d=cf.get("lr_d", 5e-4),
        adv_weight=cf.get("adv_weight", 0.01),
        perceptual_weight=cf.get("perceptual_weight", 0.001),
        grad_clip=cf.get("grad_clip", 1.0),
        mixed_precision=cf.get("mixed_precision", "bf16"),
        accum_steps=cf.get("gradient_accumulation_steps", 1),
        d_fresh_recon=cf.get("d_fresh_recon", False),
        g_init=cf.get("g_init", "torch"), device=device, seed=seed)
    layer_order = generator.encoders[0].basic_module.conv2.order

    auto = None
    start_epoch, global_step = 0, 0
    if cf.get("autoresume", True) and not cf.get("is_debug", False):
        resume_dir = cf.get("resume_dir") or os.path.join(
            cf.get("project_dir", "weights"), "autoresume_main_gan_vit")
        auto = AutoResume(os.path.abspath(resume_dir),
                          interval=cf.get("autoresume_interval", 500),
                          keep=cf.get("autoresume_keep", 2))
        # on the CPU: Adam keeps a non-capturable step count there, and a
        # generator takes its state as a CPU tensor
        saved_step, payload = auto.restore_latest(map_location="cpu")
        if payload is not None:
            trainer.load_state_dict(payload["gan"])
            start_epoch = int(payload["epoch"])
            global_step = saved_step
            print(f"[autoresume] restored step {global_step}, "
                  f"resuming at epoch {start_epoch + 1}", flush=True)

    ckpt = Checkpointer(exp.path("model_save"))
    warmup = cf.get("warmup_epochs", 10)
    num_epochs = cf["num_epochs"]
    strikes = StrikeCounter(max_strikes=cf.get("max_strikes", 10))
    step_ms = []
    for epoch in range(start_epoch, num_epochs):
        adv_on = 1.0 if (epoch + 1) > warmup else 0.0
        for step, batch in enumerate(train_loader):
            t = time.perf_counter()
            logs = trainer.train_step(torch.from_numpy(batch["image"]),
                                      torch.from_numpy(batch["label"]),
                                      adv_on)
            step_ms.append((time.perf_counter() - t) * 1e3)
            strikes.update(logs["skipped"])
            global_step += 1
            if global_step % cf.get("log_every", 10) == 0:
                exp.log_scalars(logs, global_step)
                print(f"epoch {epoch + 1} step {step}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in logs.items()),
                      flush=True)
            if auto is not None:
                auto.maybe_save(global_step, {"gan": trainer.state_dict(),
                                              "epoch": epoch})
        if auto is not None:
            # a crash in epoch N+1 resumes at its start, never replaying
            # a finished epoch
            auto.maybe_save(global_step, {"gan": trainer.state_dict(),
                                          "epoch": epoch + 1}, force=True)

        last = epoch == num_epochs - 1
        if (epoch + 1) % cf["val_inter"] == 0 or last:
            save_dir = exp.path("results_save", str(epoch + 1))
            os.makedirs(save_dir, exist_ok=True)
            for i, batch in enumerate(val_loader):
                recon = trainer.generate(torch.from_numpy(batch["image"]))
                panel = np.concatenate(
                    [batch["image"], batch["label"],
                     recon.float().cpu().numpy()], axis=1)
                save_volume_grid(panel, os.path.join(save_dir, f"{i + 1}.png"))
        if (epoch + 1) % cf["save_inter"] == 0 or last:
            save_params_npz(exp.path("model_save", "model.npz"),
                            trainer.generator, layer_order)
            ckpt.save("state", {
                "generator": trainer.generator.state_dict(),
                "discriminator": trainer.discriminator.state_dict(),
                "epoch": epoch})
    exp.close()
    return dict(trainer=trainer, exp_dir=exp.root, step_ms=step_ms,
                train_loader=train_loader, auto=auto)


if __name__ == "__main__":
    main(parse_args("Stage-1 GAN-ViT training (PyTorch port)",
                    "configs/main_gan_vit_config.yaml"))
