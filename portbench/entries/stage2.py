"""Stage-2 training: ``ClassifyTrainer.train_step(mri, x_cat, x_num,
labels)`` over the frozen generator, which returns the loss on the host.

Set-up composes the pipeline as the scoring driver does, in float32
(the trainer's master weights), fills every weight from the seed, and
builds the trainer with the configuration's learning rate, clip and
mixed precision; its dropout generator is seeded from the run's seed.
The first three steps, on rows 0-2 of a pool of distinct batches, warm
up every shape and are what the reference follows; the window steps
the same trainer on rows 3, 4, ..., cycling.

The reference draws the final feed-forward's dropout masks from a
generator seeded alike, one ``(B, 1, 2 * dim)`` draw per step, as the
program's single active dropout draws them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.core import weights
from portbench.core.compare import (explain, first_gradient, norms,
                                    training_gaps)
from portbench.entries.score import build_pipeline
from portbench.reference import gfe_mamba as ref
from portbench.reference.precision import Rounding, reference_mode
from portbench.reference.train import Adam, clip_each
from portbench.work import gfe_mamba_ops

CHECKED_STEPS = 3
TRAINED = ("combiner.", "classifier.")


def draw_rows(cfg: dict, batch: int, n: int, seed: int, device) -> list:
    """``n`` distinct ``(mri, x_cat, x_num, labels)`` batches."""
    g = weights.generator(seed, "inputs", device)
    h = cfg["head"]
    mri = torch.randn(n, batch, *cfg["img_size"], 1, generator=g,
                      device=device)
    cats = torch.stack([torch.randint(0, c, (n, batch), generator=g,
                                      device=device)
                        for c in h["categories"]], dim=-1)
    num = torch.randn(n, batch, h["num_continuous"], generator=g,
                      device=device)
    labels = torch.randint(0, 2, (n, batch), generator=g,
                           device=device).float()
    return [(mri[i], cats[i], num[i], labels[i]) for i in range(n)]


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.cfg["stage2"]["train_bc"]

    def setup(self) -> None:
        from gfe_mamba_torch.ops.cuda import build
        from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

        if self.device.type == "cuda":
            build.build()
        s2 = self.cfg["stage2"]
        model = build_pipeline(self.cfg, self.device).float()
        self.shapes = weights.draw_into(model, self.seed, torch.float32)
        self.model = model
        self.trainer = ClassifyTrainer(
            model, lr=s2["lr"], grad_clip=s2["grad_clip"],
            mixed_precision=s2["mixed_precision"], device=self.device,
            seed=weights.derive(self.seed, "dropout"))
        self.pool = draw_rows(self.cfg, self.batch, self.traffic["pool"],
                              self.seed, self.device)
        self.losses = []
        for k in range(CHECKED_STEPS):
            logs = self.trainer.train_step(*self.pool[k])
            self.losses.append(logs["cla_loss"])
            if k == 0:
                self.grad = first_gradient(self.trainer.optimizer,
                                           self.trainer.trainable)
        self.after = {n: p.detach().clone()
                      for n, p in self.trainer.trainable.items()}

    def layers(self) -> dict:
        return {}

    def item(self, i: int) -> bool:
        row = self.pool[(i + CHECKED_STEPS) % len(self.pool)]
        logs = self.trainer.train_step(*row)
        return bool(logs["skipped"]) or not math.isfinite(logs["cla_loss"])

    def counters(self) -> dict:
        return {"checked losses": self.losses}

    def release(self) -> None:
        del self.trainer, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ops(self) -> list:
        return gfe_mamba_ops(self.cfg, self.batch, train="stage2")

    def reference(self, precision: str) -> dict:
        reference_mode(precision)
        cfg, q = self.cfg, Rounding(precision)
        s2, h = cfg["stage2"], cfg["head"]
        start = weights.draw(self.shapes, self.seed, self.device,
                             torch.float32)
        P = {k: v.clone().requires_grad_(k.startswith(TRAINED))
             for k, v in start.items()}
        trained = {k: v for k, v in P.items() if k.startswith(TRAINED)}
        pool = draw_rows(cfg, self.batch, self.traffic["pool"], self.seed,
                         self.device)
        drops = weights.generator(self.seed, "dropout", self.device)
        adam = Adam(s2["lr"])
        out = {"losses": []}
        for k in range(CHECKED_STEPS):
            mri, x_cat, x_num, labels = pool[k]
            with torch.no_grad():
                mid_in, mid_out, pet = ref.generator(
                    ref.sub(P, "generator"), mri, cfg, q)
            feature = ref.combiner(ref.sub(P, "combiner"), mid_in, mid_out, q)
            keep = torch.rand((self.batch, 1, 2 * h["dim"]), generator=drops,
                              device=self.device) >= h["cross_ff_dropout"]
            logits = ref.classifier(
                ref.sub(P, "classifier"), x_cat, x_num, feature, [mri, pet],
                categories=h["categories"], depth=h["depth"],
                heads=h["heads"], q=q, dropout=(keep, h["cross_ff_dropout"]))
            loss = F.binary_cross_entropy_with_logits(logits, labels)
            grads = clip_each(dict(zip(trained, torch.autograd.grad(
                loss, list(trained.values())))), s2["grad_clip"])
            if k == 0:
                out["grad"] = norms(grads)
            adam.step(trained, grads)
            out["losses"].append(loss.item())
        out["change"] = norms({k: trained[k].detach() - start[k]
                               for k in trained})
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
