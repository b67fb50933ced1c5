"""Stage-1 GAN-ViT training (MRI -> PET), the port's counterpart of
``main_gan_vit.py``:

    python -m gfe_mamba_torch.cli.main_gan_vit \\
        --config_path configs/main_gan_vit_config.yaml [--device cpu]
    torchrun --nproc_per_node N -m gfe_mamba_torch.cli.main_gan_vit ...

The same YAML keys and the same files: a run directory
``<project_dir>/exp_<stamp>_main_gan_vit`` with the config, the loss log,
``results_save/<epoch>/<i>.png`` validation panels (MRI | PET | recon)
and ``model_save/model.npz`` (the generator in the JAX package's npz keys,
so ``classify_mamba.py`` of either package loads it) beside
``model_save/state`` (both players' weights and the epoch); with
``async_ckpt: true`` the state goes instead to ``model_save/step_<epoch>``
through an ``AsyncCheckpointManager`` (``ckpt_keep`` newest,
``ckpt_keep_best``), as in JAX.  Auto-resume snapshots live in
``<project_dir>/autoresume_main_gan_vit`` (or ``resume_dir``), written in
the background under ``async_ckpt: true``: a restarted run with the same
config restores the newest (both players, both Adams, the dropout
generators' states, the epoch) and goes on at the next epoch.

Under ``torchrun`` (``cli/common.py``) every rank trains on its rows of
each global batch of ``train_bc``; every rank restores the auto-resume
snapshot, and rank 0 alone writes the npz, the PNGs, the logs and the
snapshots, while the others wait at a barrier.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gfe_mamba_torch.cli.common import (experiment_dir, generator_kwargs,
                                        parse_args, start_processes,
                                        wait_for_main)
from gfe_mamba_torch.config import load_config
from gfe_mamba_torch.data.datasets import form_dataloader
from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.parallel import multihost
from gfe_mamba_torch.parallel.mesh import replicate
from gfe_mamba_torch.training.checkpoint import (AsyncCheckpointManager,
                                                 Checkpointer,
                                                 save_params_npz)
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.training.resilience import AutoResume, StrikeCounter
from gfe_mamba_torch.utils.convert import jax_tree_from_state_dict
from gfe_mamba_torch.utils.experiment import save_volume_grid


def main(args) -> dict:
    """Train; returns the trainer, the run directory, each step's wall
    milliseconds and the train loader (its wait per batch)."""
    cf = load_config(args.config_path)
    device, mesh, local_bc, shard = start_processes(args, cf)
    main_rank = multihost.is_main_process()
    exp = experiment_dir(args.config_path, cf, "weights", "main_gan_vit")
    img_sz = tuple(cf["img_sz"])
    seed = cf.get("seed", 0)
    train_loader = form_dataloader(cf["train_path"], img_sz, local_bc,
                                   shuffle=True, seed=seed,
                                   num_workers=cf.get("num_workers", 2),
                                   process_shard=shard)
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
        g_init=cf.get("g_init", "torch"), device=device, seed=seed,
        mesh=mesh)
    replicate(trainer.generator)
    replicate(trainer.discriminator)
    layer_order = generator.encoders[0].basic_module.conv2.order
    async_ckpt = cf.get("async_ckpt", False)

    auto = None
    start_epoch, global_step = 0, 0
    if cf.get("autoresume", True) and not cf.get("is_debug", False):
        resume_dir = cf.get("resume_dir") or os.path.join(
            cf.get("project_dir", "weights"), "autoresume_main_gan_vit")
        auto = AutoResume(os.path.abspath(resume_dir),
                          interval=cf.get("autoresume_interval", 500),
                          keep=cf.get("autoresume_keep", 2),
                          async_save=async_ckpt)
        # on the CPU: Adam keeps a non-capturable step count there, and a
        # generator takes its state as a CPU tensor
        saved_step, payload = auto.restore_latest(map_location="cpu")
        if payload is not None:
            trainer.load_state_dict(payload["gan"])
            start_epoch = int(payload["epoch"])
            global_step = saved_step
            if main_rank:
                print(f"[autoresume] restored step {global_step}, "
                      f"resuming at epoch {start_epoch + 1}", flush=True)

    if async_ckpt:
        ckpt = AsyncCheckpointManager(exp.path("model_save"),
                                      max_to_keep=cf.get("ckpt_keep", 3),
                                      keep_best=cf.get("ckpt_keep_best", 1))
    else:
        ckpt = Checkpointer(exp.path("model_save")) if main_rank else None
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
            if global_step % cf.get("log_every", 10) == 0 and main_rank:
                exp.log_scalars(logs, global_step)
                print(f"epoch {epoch + 1} step {step}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in logs.items()),
                      flush=True)
            if auto is not None and auto.due(global_step):
                auto.maybe_save(global_step, {"gan": trainer.state_dict(),
                                              "epoch": epoch})
        if auto is not None:
            # a crash in epoch N+1 resumes at its start, never replaying
            # a finished epoch
            auto.maybe_save(global_step, {"gan": trainer.state_dict(),
                                          "epoch": epoch + 1}, force=True)

        last = epoch == num_epochs - 1
        do_val = (epoch + 1) % cf["val_inter"] == 0 or last
        do_save = (epoch + 1) % cf["save_inter"] == 0 or last
        if do_val and main_rank:
            save_dir = exp.path("results_save", str(epoch + 1))
            os.makedirs(save_dir, exist_ok=True)
            for i, batch in enumerate(val_loader):
                recon = trainer.generate(torch.from_numpy(batch["image"]))
                panel = np.concatenate(
                    [batch["image"], batch["label"],
                     recon.float().cpu().numpy()], axis=1)
                save_volume_grid(panel, os.path.join(save_dir, f"{i + 1}.png"))
        if do_save:
            # collective: every rank gathers, rank 0 writes
            g_host = multihost.host_local(trainer.generator)
            d_host = multihost.host_local(trainer.discriminator)
            if main_rank:
                save_params_npz(exp.path("model_save", "model.npz"), g_host,
                                layer_order)
            if async_ckpt:
                ckpt.save(epoch + 1, {
                    "g_params": jax_tree_from_state_dict(g_host, layer_order),
                    "d_params": jax_tree_from_state_dict(d_host),
                    "epoch": epoch})
            elif main_rank:
                ckpt.save("state", {"generator": g_host,
                                    "discriminator": d_host, "epoch": epoch})
        if do_val or do_save:
            wait_for_main()
    if auto is not None:
        auto.close()
    if async_ckpt:
        ckpt.close()
    exp.close()
    return dict(trainer=trainer, exp_dir=exp.root, step_ms=step_ms,
                train_loader=train_loader, auto=auto)


if __name__ == "__main__":
    main(parse_args("Stage-1 GAN-ViT training (PyTorch port)",
                    "configs/main_gan_vit_config.yaml"))
    multihost.shutdown()
