"""Scoring: ``GFEMamba.forward(mri, x_cat, x_num, return_pet=True)``,
each request synchronised and its logits read on the host.

Set-up composes the pipeline from the program's classes on the meta
device, as ``build_gfe_mamba`` does, materialises it on the card in the
served dtype and fills every weight from the seed; a pool of distinct
inputs is drawn on the card, and each request takes the next one.  A
reservoir drawn from the seed keeps the outputs of a uniform sample of
the window's requests; once the window has closed the reference scores
the same inputs in float32 and the widest gaps are compared."""

from __future__ import annotations

import random

import torch

from portbench.core import weights
from portbench.reference import gfe_mamba as ref
from portbench.reference.precision import Rounding, reference_mode
from portbench.work import gfe_mamba_ops

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def meta_generator(cfg: dict):
    """The program's GAN-ViT generator at ``cfg`` on the meta device."""
    from gfe_mamba_torch.models.unet3d import ResidualMidUNet3DViT

    g = cfg["generator"]
    with torch.device("meta"):
        return ResidualMidUNet3DViT(
            1, 1, f_maps=tuple(g["f_maps"]), layer_order=g["layer_order"],
            num_groups=g["num_groups"], img_size=tuple(cfg["img_size"]),
            fold_factor=g["fold_factor"], vit_patch_size=g["vit_patch_size"],
            vit_dim=g["vit_dim"], vit_depth=g["vit_depth"],
            vit_heads=g["vit_heads"], vit_mlp_dim=g["vit_mlp_dim"],
            vit_dropout=g["vit_dropout"],
            vit_emb_dropout=g["vit_emb_dropout"])


def build_pipeline(cfg: dict, device):
    """The program's pipeline at ``cfg``, on ``device``, weights empty."""
    from gfe_mamba_torch.models.combiners import CombineClassifierVitMid
    from gfe_mamba_torch.models.fusion import CrossMambaBoth
    from gfe_mamba_torch.models.pipeline import GFEMamba

    h = cfg["head"]
    if h["mixer"] != "mamba":
        raise ValueError(f"mixer {h['mixer']!r}: this driver builds the "
                         f"Mamba head")
    gen = meta_generator(cfg)
    with torch.device("meta"):
        mid_h, mid_w = gen.mid_size
        combiner = CombineClassifierVitMid(mid_h * mid_w, h["seq_length"])
        x, y, _ = cfg["img_size"]
        head = CrossMambaBoth(tuple(h["categories"]), h["num_continuous"],
                              dim=h["dim"], depth=h["depth"],
                              heads=h["heads"], d_cross=x * y,
                              dim_out=h["dim_out"],
                              cross_ff_dropout=h["cross_ff_dropout"])
        model = GFEMamba(gen, combiner, head)
    return model.to_empty(device=device)


def draw_inputs(cfg: dict, batch: int, n: int, seed: int, device,
                dtype) -> list:
    """``n`` distinct requests ``(mri, x_cat, x_num)`` from the seed."""
    g = weights.generator(seed, "inputs", device)
    h = cfg["head"]
    img = tuple(cfg["img_size"])
    mri = torch.randn(n, batch, *img, 1, generator=g, device=device,
                      dtype=dtype)
    cats = torch.stack([torch.randint(0, c, (n, batch), generator=g,
                                      device=device)
                        for c in h["categories"]], dim=-1)
    num = torch.randn(n, batch, h["num_continuous"], generator=g,
                      device=device, dtype=dtype)
    return [(mri[i], cats[i], num[i]) for i in range(n)]


def gaps(logits, pet, want_logits, want_pet) -> dict:
    """The widest logit gap and the PET's relative distance (L2)."""
    logits = logits.to(want_logits.device).float().flatten()
    return {"logit_abs": (logits - want_logits.float().flatten()).abs()
            .max().item(),
            "pet_rel": (torch.linalg.vector_norm(pet.float() - want_pet)
                        / torch.linalg.vector_norm(want_pet)).item()}


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = self.traffic["batch"]
        self.dtype = DTYPES[self.cfg["dtype"]]
        self.kept = []
        self.rng = random.Random(weights.derive(seed, "sample"))

    def setup(self) -> None:
        from gfe_mamba_torch.ops.cuda import build
        if self.device.type == "cuda":
            build.build()
        model = build_pipeline(self.cfg, self.device).to(self.dtype)
        self.shapes = weights.draw_into(model, self.seed, self.dtype)
        self.model = model.eval()
        self.pool = draw_inputs(self.cfg, self.batch, self.traffic["pool"],
                                self.seed, self.device, self.dtype)
        for i in range(self.traffic["warmup"]):
            self.item(-1 - i)

    def layers(self) -> dict:
        m = self.model
        return {"generator": [m.generator],
                "classifier": [m.combiner, m.classifier]}

    def item(self, i: int) -> bool:
        mri, x_cat, x_num = self.pool[i % len(self.pool)]
        with torch.inference_mode():
            logits, pet = self.model(mri, x_cat, x_num, return_pet=True)
        host = logits.float().cpu()
        if i >= 0:
            self.keep(i, host, pet)
        return not bool(torch.isfinite(host).all())

    def keep(self, i, logits, pet) -> None:
        """Algorithm R: a uniform sample of ``sample`` requests."""
        k = self.traffic["sample"]
        if len(self.kept) < k:
            self.kept.append((i, logits, pet))
        else:
            j = self.rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, logits, pet)

    def counters(self) -> dict:
        return {"sampled requests": sorted(i for i, _, _ in self.kept)}

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def ops(self) -> list:
        return gfe_mamba_ops(self.cfg, self.batch)

    def _reference_inputs(self, precision: str = "f32"):
        reference_mode(precision)
        P = {k: v.float() for k, v in weights.draw(
            self.shapes, self.seed, self.device, self.dtype).items()}
        pool = draw_inputs(self.cfg, self.batch, self.traffic["pool"],
                           self.seed, self.device, self.dtype)
        return P, pool

    def check(self) -> dict:
        """The widest gaps of the kept requests from the reference."""
        P, pool = self._reference_inputs()
        worst = {}
        for i, logits, pet in self.kept:
            with torch.no_grad():
                want = ref.forward(P, *pool[i % len(pool)], self.cfg,
                                   Rounding("f32"))
            for k, v in gaps(logits, pet, *want).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control(self, precision: str) -> dict:
        """The reference in ``precision`` in the program's place, judged
        against the reference in float32 on the same requests."""
        P, pool = self._reference_inputs(precision)
        worst = {}
        for i, _, _ in self.kept:
            with torch.no_grad():
                low = ref.forward(P, *pool[i % len(pool)], self.cfg,
                                  Rounding(precision))
                want = ref.forward(P, *pool[i % len(pool)], self.cfg,
                                   Rounding("f32"))
            for k, v in gaps(*low, *want).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
