"""Segmentation training: ``UNetTrainer.train_step(raw, label)``, which
returns the loss as a float (so each step ends on the host).

Set-up builds pytorch-3dunet's UNet3D with the program's ``get_model``,
fills every weight from the seed on the card, builds the trainer with
the configuration's loss and optimizer, draws a pool of distinct
patches and labels, and takes the first three steps on rows 0-2: they
warm up every shape and are what the reference follows.  The window
steps the same trainer on rows 3, 4, ... of the pool, cycling."""

from __future__ import annotations

import math

import torch

from portbench.core import weights
from portbench.core.compare import (explain, first_gradient, norms,
                                    training_gaps)
from portbench.core.registry import PACKAGE
from portbench.reference.precision import Rounding, reference_mode
from portbench.reference.train import Adam, bce_dice
from portbench.reference.unet import unet3d_logits
from portbench.work import unet3d_ops

CHECKED_STEPS = 3


def draw_rows(cfg: dict, n: int, seed: int, device) -> list:
    """``n`` distinct ``(raw, label)`` batches, channels-last."""
    g = weights.generator(seed, "inputs", device)
    shape = (n, cfg["train_bc"], *cfg["patch"], cfg["in_channels"])
    raw = torch.randn(shape, generator=g, device=device)
    label = (torch.rand(shape[:-1] + (cfg["out_channels"],), generator=g,
                        device=device) > 0.5).float()
    return [(raw[i], label[i]) for i in range(n)]


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.cfg["train_bc"]

    def setup(self) -> None:
        from gfe_mamba_torch.models.unet3d import get_model
        from gfe_mamba_torch.ops.cuda import build
        from gfe_mamba_torch.segmentation.trainer import UNetTrainer

        cfg = self.cfg
        if self.device.type == "cuda":
            build.build()
            torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
            torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        model = get_model(dict(
            name="UNet3D", in_channels=cfg["in_channels"],
            out_channels=cfg["out_channels"], f_maps=cfg["f_maps"],
            num_levels=cfg["num_levels"], layer_order=cfg["layer_order"],
            num_groups=cfg["num_groups"])).to(self.device)
        self.shapes = weights.draw_into(model, self.seed, torch.float32)
        self.model = model
        self.trainer = UNetTrainer(
            model, {"loss": {"name": cfg["loss"]},
                    "eval_metric": {"name": "DiceCoefficient"},
                    "optimizer": cfg["optimizer"]},
            str(PACKAGE / ".cache" / "seg_checkpoints"), device=self.device)
        self.trainer.init_state(weights.derive(self.seed, "dropout"))
        self.pool = draw_rows(cfg, self.traffic["pool"], self.seed,
                              self.device)
        named = dict(model.named_parameters())
        self.losses = []
        for k in range(CHECKED_STEPS):
            self.losses.append(self.trainer.train_step(*self.pool[k]))
            if k == 0:
                self.grad = first_gradient(self.trainer.optimizer, named)
        self.after = {n: p.detach().clone() for n, p in named.items()}

    def layers(self) -> dict:
        return {}

    def item(self, i: int) -> bool:
        raw, label = self.pool[(i + CHECKED_STEPS) % len(self.pool)]
        return not math.isfinite(self.trainer.train_step(raw, label))

    def counters(self) -> dict:
        return {"checked losses": self.losses}

    def release(self) -> None:
        del self.trainer, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ops(self) -> list:
        return unet3d_ops(self.cfg, self.batch, train=True)

    def reference(self, precision: str) -> dict:
        """The reference's first three steps from the same weights and
        rows: losses, the first gradient's norms, the change's norms."""
        reference_mode(precision)
        cfg, q = self.cfg, Rounding(precision)
        start = weights.draw(self.shapes, self.seed, self.device,
                             torch.float32)
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        pool = draw_rows(cfg, self.traffic["pool"], self.seed, self.device)
        adam = Adam(cfg["optimizer"]["learning_rate"])
        out = {"losses": []}
        for k in range(CHECKED_STEPS):
            raw, label = pool[k]
            logits = unet3d_logits(params, raw.permute(0, 4, 1, 2, 3),
                                   levels=cfg["num_levels"],
                                   order=cfg["layer_order"],
                                   groups=cfg["num_groups"], q=q)
            loss = bce_dice(logits, label.permute(0, 4, 1, 2, 3))
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            if k == 0:
                out["grad"] = norms(grads)
            adam.step(params, grads)
            out["losses"].append(loss.item())
        out["change"] = norms({k: params[k].detach() - start[k]
                               for k in params})
        return out

    def check(self) -> dict:
        want = self.reference("f32")
        start = weights.draw(self.shapes, self.seed, self.device,
                             torch.float32)
        got = {"losses": self.losses, "grad": self.grad,
               "change": norms({k: self.after[k] - start[k]
                                for k in self.after})}
        self.explained = explain(got, want)
        return training_gaps(got, want)

    def control(self, precision: str) -> dict:
        return training_gaps(self.reference(precision),
                             self.reference("f32"))
