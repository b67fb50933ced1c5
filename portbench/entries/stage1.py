"""Stage-1 training: ``GanTrainer.train_step(mri, pet, adv_on)``, the
MRI-to-PET generator against the PatchGAN discriminator and the
perceptual loss, which returns its losses on the host.

Set-up composes the generator from the program's class on the meta
device, as ``build_generator`` does, materialises it on the card in
float32 (the trainer's master weights), builds the program's
``PatchDiscriminator`` and ``PerceptualLoss``, and fills every weight of
the three from the seed (a stream each).  The trainer's dropout
generator is seeded from the run's seed.  The first three steps, on
rows 0-2 of a pool of distinct (MRI, PET) pairs, warm up every shape
and are what the reference follows; the window steps the same trainer
on rows 3, 4, ..., cycling.

The reference draws the generator's ViT dropout masks from a generator
seeded alike, in the order the forward meets them (the embeddings, then
per block the attention map, the attention output and both
feed-forward layers); the configuration's two ViT rates are equal."""

from __future__ import annotations

import math

import torch

from portbench.core import weights
from portbench.core.compare import (explain, first_gradient, norms,
                                    training_gaps)
from portbench.entries.score import meta_generator
from portbench.reference import gfe_mamba as ref
from portbench.reference.layers import Dropout
from portbench.reference.patchgan import discriminator
from portbench.reference.perceptual import perceptual
from portbench.reference.precision import Rounding, reference_mode
from portbench.reference.train import Adam, clip_global
from portbench.work import stage1_ops

CHECKED_STEPS = 3
STREAMS = ("weights", "weights.discriminator", "weights.perceptual")


def draw_rows(cfg: dict, batch: int, n: int, seed: int, device) -> list:
    """``n`` distinct ``(mri, pet)`` pairs."""
    g = weights.generator(seed, "inputs", device)
    vols = torch.randn(n, 2, batch, *cfg["img_size"], 1, generator=g,
                       device=device)
    return [(vols[i, 0], vols[i, 1]) for i in range(n)]


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.s1 = self.cfg["stage1"]
        self.batch = self.s1["train_bc"]
        g = self.cfg["generator"]
        if g["vit_dropout"] != g["vit_emb_dropout"]:
            raise ValueError("the reference draws one ViT dropout rate")

    def setup(self) -> None:
        from gfe_mamba_torch.losses.perceptual import PerceptualLoss
        from gfe_mamba_torch.models.discriminator import PatchDiscriminator
        from gfe_mamba_torch.ops.cuda import build
        from gfe_mamba_torch.training.gan_trainer import GanTrainer

        if self.device.type == "cuda":
            build.build()
        s1 = self.s1
        gen = meta_generator(self.cfg).to_empty(device=self.device)
        disc = PatchDiscriminator(s1["discriminator_layers"],
                                  s1["discriminator_channels"]
                                  ).to(self.device)
        perc = PerceptualLoss(s1["fake_3d_ratio"], device=self.device)
        self.shapes = [weights.draw_into(m, self.seed, torch.float32, tag)
                       for m, tag in zip((gen, disc, perc.net), STREAMS)]
        self.model = gen
        self.trainer = GanTrainer(
            gen, disc, perc, lr_g=s1["lr_g"], lr_d=s1["lr_d"],
            adv_weight=s1["adv_weight"],
            perceptual_weight=s1["perceptual_weight"],
            grad_clip=s1["grad_clip"], mixed_precision=s1["mixed_precision"],
            device=self.device, seed=weights.derive(self.seed, "dropout"))
        self.pool = draw_rows(self.cfg, self.batch, self.traffic["pool"],
                              self.seed, self.device)
        self.losses = []
        for k in range(CHECKED_STEPS):
            logs = self.trainer.train_step(*self.pool[k], s1["adv_on"])
            self.losses.append((logs["g_loss"], logs["d_loss"]))
            if k == 0:
                self.grad = [first_gradient(opt, params) for opt, params
                             in ((self.trainer.g_opt, self.trainer.g_params),
                                 (self.trainer.d_opt, self.trainer.d_params))]
        self.after = [{n: p.detach().clone() for n, p in params.items()}
                      for params in (self.trainer.g_params,
                                     self.trainer.d_params)]

    def layers(self) -> dict:
        return {}

    def item(self, i: int) -> bool:
        mri, pet = self.pool[(i + CHECKED_STEPS) % len(self.pool)]
        logs = self.trainer.train_step(mri, pet, self.s1["adv_on"])
        return bool(logs["skipped"]) or not math.isfinite(logs["g_loss"])

    def counters(self) -> dict:
        return {"checked losses (G, D)": self.losses}

    def release(self) -> None:
        del self.trainer, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ops(self) -> list:
        return stage1_ops(self.cfg, self.batch)

    def _start(self):
        return [weights.draw(shapes, self.seed, self.device, torch.float32,
                             tag) for shapes, tag in zip(self.shapes,
                                                         STREAMS)]

    def reference(self, precision: str) -> list:
        """The reference's first three steps: per player (G, D), the
        losses, the first gradient's norms and the change's norms."""
        reference_mode(precision)
        cfg, s1, q = self.cfg, self.s1, Rounding(precision)
        g0, d0, p0 = self._start()
        G = {k: v.clone().requires_grad_(True) for k, v in g0.items()}
        D = {k: v.clone().requires_grad_(True) for k, v in d0.items()}
        pool = draw_rows(cfg, self.batch, self.traffic["pool"], self.seed,
                         self.device)
        drop = Dropout(weights.generator(self.seed, "dropout", self.device),
                       cfg["generator"]["vit_dropout"])
        adam_g, adam_d = Adam(s1["lr_g"]), Adam(s1["lr_d"])
        layers, adv = s1["discriminator_layers"], s1["adv_on"]
        out = [{"losses": []}, {"losses": []}]
        for k in range(CHECKED_STEPS):
            mri, pet = pool[k]
            _, _, recon = ref.generator(G, mri, cfg, q, drop)
            frozen = {n: v.detach() for n, v in D.items()}
            fake = discriminator(frozen, recon, layers, q)[-1]
            loss_g = (torch.mean(torch.abs(recon - pet))
                      + s1["perceptual_weight"] * perceptual(
                          p0, recon, pet, s1["fake_3d_ratio"], q)
                      + adv * s1["adv_weight"] * torch.mean((fake - 1) ** 2))
            g_grads = clip_global(dict(zip(G, torch.autograd.grad(
                loss_g, list(G.values())))), s1["grad_clip"])
            fake = discriminator(D, recon.detach(), layers, q)[-1]
            real = discriminator(D, pet, layers, q)[-1]
            loss_d = adv * s1["adv_weight"] * 0.5 * (
                torch.mean(fake ** 2) + torch.mean((real - 1) ** 2))
            d_grads = dict(zip(D, torch.autograd.grad(
                loss_d, list(D.values()))))
            if k == 0:
                out[0]["grad"], out[1]["grad"] = norms(g_grads), \
                    norms(d_grads)
            adam_g.step(G, g_grads)
            adam_d.step(D, d_grads)
            out[0]["losses"].append(loss_g.item())
            out[1]["losses"].append(loss_d.item())
        for o, now, start in zip(out, (G, D), (g0, d0)):
            o["change"] = norms({n: now[n].detach() - start[n] for n in now})
        return out

    @staticmethod
    def _worst(pairs) -> dict:
        """Each number's worst over the two players."""
        gaps = [training_gaps(got, want) for got, want in pairs]
        return {k: max(g[k] for g in gaps) for k in gaps[0]}

    def check(self) -> dict:
        want = self.reference("f32")
        start = self._start()[:2]
        got = [{"losses": [l[i] for l in self.losses], "grad": self.grad[i],
                "change": norms({n: self.after[i][n] - start[i][n]
                                 for n in self.after[i]})}
               for i in range(2)]
        self.explained = [explain(g, w) for g, w in zip(got, want)]
        return self._worst(zip(got, want))

    def control(self, precision: str) -> dict:
        return self._worst(zip(self.reference(precision),
                               self.reference("f32")))
