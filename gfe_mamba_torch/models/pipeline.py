"""The end-to-end GFE-Mamba forward (counterpart of
``gfe_mamba_tpu/models/pipeline.py``):

    mid_input, mid_output, pet = generator(mri, output_vit_mid=True)
    feature = combiner(mid_input, mid_output)
    logit   = classifier(x_categ, x_numer, feature, [mri, pet])
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.models.combiners import CombineClassifierVitMid
from gfe_mamba_torch.models.ft_transformer import CrossTransformerBoth
from gfe_mamba_torch.models.fusion import CrossJambaBoth, CrossMambaBoth
from gfe_mamba_torch.models.unet3d import ResidualMidUNet3DViT
from gfe_mamba_torch.utils.initializers import init_weights
from gfe_mamba_torch.utils.profiling import annotate


class GFEMamba(nn.Module):
    """generator (frozen) -> combiner -> fusion classifier.

    The generator is frozen, as in the JAX pipeline: it runs under
    ``torch.no_grad()`` and stays in eval mode (its ViT dropout off) when
    the model is put in train mode."""

    def __init__(self, generator: ResidualMidUNet3DViT,
                 combiner: CombineClassifierVitMid,
                 classifier: nn.Module):
        super().__init__()
        self.generator = generator
        self.combiner = combiner
        self.classifier = classifier

    def train(self, mode: bool = True) -> GFEMamba:
        super().train(mode)
        self.generator.eval()
        return self

    def forward(self, mri: torch.Tensor, x_categ: torch.Tensor,
                x_numer: torch.Tensor, return_pet: bool = False):
        with annotate("gfe.generator"), torch.no_grad():
            mid_input, mid_output, pet = self.generator(mri,
                                                        output_vit_mid=True)
        with annotate("gfe.classifier"):
            feature_img = self.combiner(mid_input, mid_output)
            logits = self.classifier(x_categ, x_numer, feature_img,
                                     [mri, pet])
        if return_pet:
            return logits, pet
        return logits


def _materialize(module: nn.Module, seed: int, device,
                 dtype: torch.dtype) -> nn.Module:
    """A module built on the meta device, filled on the CPU from ``seed``
    (so a seed gives the same weights on every device), then moved."""
    module.to_empty(device="cpu")
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device=device, dtype=dtype)


def build_gfe_mamba(*, categories: Sequence[int], num_continuous: int,
                    dim: int = 512, depth: int = 6, heads: int = 8,
                    dim_out: int = 1, attn_dropout: float = 0.1,
                    ff_dropout: float = 0.1, seq_length: int = 4,
                    mixer: str = "mamba", cross_ff_dropout: float = 0.1,
                    seed: int = 0, device=None,
                    dtype: torch.dtype = torch.float32,
                    **generator_kwargs) -> GFEMamba:
    """Build the canonical pipeline in eval mode with weights drawn from
    ``seed``, on ``device`` (CUDA unless ``device="cpu"``) in ``dtype``.

    ``mixer`` picks the classifier: ``"mamba"`` (:class:`CrossMambaBoth`),
    ``"jamba"`` (:class:`CrossJambaBoth`, GQA attention dropout
    ``attn_dropout``) or ``"transformer"`` (:class:`CrossTransformerBoth`,
    ``dim // heads`` per head, ``attn_dropout`` and ``ff_dropout``); the
    Mamba head has no dropout but its final feed-forward's
    (``cross_ff_dropout``, every head).  ``generator_kwargs`` are
    :class:`ResidualMidUNet3DViT`'s (``img_size``, ``f_maps``,
    ``layer_order``, ``fold_factor``, ``vit_*``), with its defaults.
    ``img_size`` is the MRI volume's (X, Y, Z): torch sizes the ViT, the
    combiner and the cross-attention from it at construction."""
    device = resolve_device(device)
    if mixer not in ("mamba", "jamba", "transformer"):
        raise ValueError(f"unknown mixer {mixer!r}")
    with torch.device("meta"):
        generator = ResidualMidUNet3DViT(1, 1, **generator_kwargs)
        mid_h, mid_w = generator.mid_size
        combiner = CombineClassifierVitMid(mid_h * mid_w, seq_length)
        img_x, img_y, _ = generator.img_size
        head = dict(dim=dim, depth=depth, heads=heads, d_cross=img_x * img_y,
                    dim_out=dim_out, cross_ff_dropout=cross_ff_dropout)
        if mixer == "mamba":
            classifier = CrossMambaBoth(categories, num_continuous, **head)
        elif mixer == "jamba":
            classifier = CrossJambaBoth(categories, num_continuous,
                                        attn_dropout=attn_dropout, **head)
        else:
            classifier = CrossTransformerBoth(
                categories, num_continuous, dim_head=dim // heads,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout, **head)
        model = GFEMamba(generator, combiner, classifier)
    return _materialize(model, seed, device, dtype).eval()


def build_generator(*, seed: int = 0, device=None,
                    **generator_kwargs) -> ResidualMidUNet3DViT:
    """The Stage-1 generator alone (``generator_kwargs`` as in
    :func:`build_gfe_mamba`), f32 weights drawn from ``seed`` as
    :func:`build_gfe_mamba` draws them, on ``device`` (CUDA unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    with torch.device("meta"):
        generator = ResidualMidUNet3DViT(1, 1, **generator_kwargs)
    return _materialize(generator, seed, device, torch.float32)
