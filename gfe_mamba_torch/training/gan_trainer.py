"""Stage-1 GAN-ViT training (counterpart of
``gfe_mamba_tpu/training/gan_trainer.py``).

One step, per microbatch:

    recon = G(mri)                                  (compute dtype, train)
    L_G = L1(recon, pet) + pw * perceptual(recon, pet)
          + adv_on * aw * LS(D(recon)[-1] -> real)  (D's weights detached)
    L_D = adv_on * aw * 0.5 * (LS(D(recon.detach())[-1] -> fake)
                               + LS(D(pet)[-1] -> real))

then G takes the optax global-norm clip and Adam, D plain Adam.  D runs
in f32, as in the JAX trainer.  While ``adv_on == 0`` (the warm-up) D's
parameters and Adam state do not move at all; a step whose losses or
gradients are not all finite moves neither player's parameters nor Adam
moments, but advances the Adam step count of G, and of D when
``adv_on > 0``, as optax's integer count advances under the JAX
trainer's finite guard (which runs after D's warm-up gate).
``accum_steps`` averages both players' gradients over that many
microbatches of the batch; ``d_fresh_recon`` trains D on a second,
no-grad generator forward with the updated G (the reference loop's
order) instead of the shared reconstruction.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn
from torch.func import functional_call

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.losses.gan import patch_adversarial_loss
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.training.optim import (advance_adam_count_, all_finite,
                                            cast_for_compute,
                                            clip_by_global_norm_,
                                            compute_dtype)
from gfe_mamba_torch.utils.initializers import check_law, init_weights


class GanTrainer:
    """Trains ``generator`` and ``discriminator`` (f32 master weights) in
    place against ``perceptual_loss`` (frozen).  Dropout masks come from
    a generator seeded with ``seed``.  ``g_init`` is the generator's init
    law (``utils/initializers.py``): ``"torch"`` keeps the weights
    ``build_generator`` drew under that law, ``"flax"`` draws them again from
    ``seed`` under flax's; the discriminator keeps its own (DCGAN) law
    under both, as in the JAX trainer."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 perceptual_loss: nn.Module, lr_g: float = 1e-4,
                 lr_d: float = 5e-4, adv_weight: float = 0.01,
                 perceptual_weight: float = 0.001, grad_clip: float = 1.0,
                 mixed_precision: str = "bf16", accum_steps: int = 1,
                 d_fresh_recon: bool = False, device=None, seed: int = 0,
                 g_init: str = "torch"):
        self.accum = max(1, accum_steps)
        if d_fresh_recon and self.accum > 1:
            raise ValueError("d_fresh_recon requires accum_steps == 1")
        if check_law(g_init) == "flax":
            init_weights(generator, torch.Generator().manual_seed(seed),
                         "flax")
        self.device = resolve_device(device)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        self.perceptual_loss = perceptual_loss.to(self.device)
        perceptual_loss.requires_grad_(False)
        self.g_params = dict(generator.named_parameters())
        self.d_params = dict(discriminator.named_parameters())
        self.g_opt = torch.optim.Adam(self.g_params.values(), lr=lr_g)
        self.d_opt = torch.optim.Adam(self.d_params.values(), lr=lr_d)
        self.adv_weight = adv_weight
        self.perceptual_weight = perceptual_weight
        self.grad_clip = grad_clip
        self.d_fresh_recon = d_fresh_recon
        self.dtype = compute_dtype(mixed_precision)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        seed_dropout(generator, self.rng)
        self.step = 0

    def _recon(self, mri: torch.Tensor) -> torch.Tensor:
        params = cast_for_compute(self.g_params, self.dtype)
        return functional_call(self.generator, params,
                               (mri.to(self.dtype),)).float()

    def _g_loss(self, mri, pet, adv_on):
        recon = self._recon(mri)
        l1 = torch.mean(torch.abs(recon - pet))
        p_loss = self.perceptual_loss(recon, pet)
        frozen_d = {k: v.detach() for k, v in self.d_params.items()}
        logits_fake = functional_call(self.discriminator, frozen_d,
                                      (recon,))[-1]
        gen_adv = patch_adversarial_loss(logits_fake, True, False)
        loss = (l1 + self.perceptual_weight * p_loss
                + adv_on * self.adv_weight * gen_adv)
        return loss, recon, (l1, p_loss, gen_adv)

    def _d_loss(self, recon, pet, adv_on):
        fake = self.discriminator(recon.detach())[-1]
        real = self.discriminator(pet)[-1]
        return adv_on * self.adv_weight * 0.5 * (
            patch_adversarial_loss(fake, False, True)
            + patch_adversarial_loss(real, True, True))

    def _grads(self, loss, params: dict) -> list[torch.Tensor]:
        return list(torch.autograd.grad(loss, list(params.values()),
                                        materialize_grads=True))

    @staticmethod
    def _apply(opt, params: dict, grads) -> None:
        for p, g in zip(params.values(), grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def _step_g(self, grads) -> None:
        clip_by_global_norm_(grads, self.grad_clip)
        self._apply(self.g_opt, self.g_params, grads)

    def train_step(self, mri, pet, adv_on) -> dict[str, float]:
        """One G + D update; ``adv_on`` is the 0/1 warm-up gate.  Returns
        ``{"g_loss", "d_loss", "l1", "perceptual", "gen_adv",
        "skipped"}``, each averaged over the microbatches."""
        mri, pet = mri.to(self.device), pet.to(self.device)
        adv_on = float(adv_on)
        if mri.shape[0] % self.accum:
            raise ValueError(f"batch {mri.shape[0]} does not split into "
                             f"{self.accum} microbatches")
        self.generator.train()
        self.discriminator.train()
        n = self.accum
        g_sum = d_sum = None
        logs = dict.fromkeys(("g_loss", "d_loss", "l1", "perceptual",
                              "gen_adv"), 0.0)
        for mri_mb, pet_mb in zip(mri.chunk(n), pet.chunk(n)):
            loss_g, recon, (l1, p_loss, gen_adv) = self._g_loss(
                mri_mb, pet_mb, adv_on)
            g_grads = self._grads(loss_g, self.g_params)
            g_sum = g_grads if g_sum is None else \
                [a + b for a, b in zip(g_sum, g_grads)]
            for key, v in (("g_loss", loss_g), ("l1", l1),
                           ("perceptual", p_loss), ("gen_adv", gen_adv)):
                logs[key] += float(v.detach()) / n
            if not self.d_fresh_recon:
                loss_d = self._d_loss(recon, pet_mb, adv_on)
                d_grads = self._grads(loss_d, self.d_params)
                d_sum = d_grads if d_sum is None else \
                    [a + b for a, b in zip(d_sum, d_grads)]
                logs["d_loss"] += float(loss_d.detach()) / n
        g_grads = [g / n for g in g_sum]

        if self.d_fresh_recon:
            # G first, then D against a fresh no-grad forward of the
            # updated G; undone below if the step turns out non-finite
            backup = ([p.detach().clone() for p in self.g_params.values()],
                      copy.deepcopy(self.g_opt.state_dict()))
            finite_g = all_finite(g_grads)
            self._step_g(g_grads)
            with torch.no_grad():
                recon_d = self._recon(mri)
            loss_d = self._d_loss(recon_d, pet, adv_on)
            d_grads = self._grads(loss_d, self.d_params)
            logs["d_loss"] = float(loss_d.detach())
            ok = (finite_g and math.isfinite(logs["g_loss"])
                  and all_finite([loss_d, *d_grads]))
            if not ok:
                with torch.no_grad():
                    for p, b in zip(self.g_params.values(), backup[0]):
                        p.copy_(b)
                self.g_opt.load_state_dict(backup[1])
        else:
            d_grads = [g / n for g in d_sum]
            ok = (math.isfinite(logs["g_loss"])
                  and math.isfinite(logs["d_loss"])
                  and all_finite([*g_grads, *d_grads]))
            if ok:
                self._step_g(g_grads)
        if not ok:
            advance_adam_count_(self.g_opt, self.g_params.values())
            if adv_on > 0:
                advance_adam_count_(self.d_opt, self.d_params.values())
        elif adv_on > 0:
            self._apply(self.d_opt, self.d_params, d_grads)
        self.step += 1
        logs["skipped"] = 0.0 if ok else 1.0
        return logs

    def state_dict(self) -> dict:
        """What a resumed run needs: both players' and both Adams' state
        dicts, the dropout generator's state and the step count."""
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(),
                "rng": self.rng.get_state(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.generator.load_state_dict(state["generator"])
        self.discriminator.load_state_dict(state["discriminator"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        self.rng.set_state(state["rng"])
        self.step = int(state["step"])

    @torch.no_grad()
    def generate(self, mri: torch.Tensor) -> torch.Tensor:
        """Eval-mode reconstruction in the master dtype."""
        self.generator.eval()
        return self.generator(mri.to(self.device))
