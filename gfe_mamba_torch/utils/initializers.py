"""The two init laws of the trainers (counterpart of
``gfe_mamba_tpu/utils/initializers.py``), drawn from a ``torch.Generator``.

* ``"torch"`` (the default of both trainers): every Dense/Conv weight and
  bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's Linear/ConvNd law.
* ``"flax"``: what a flax tree holds at ``init``: lecun_normal weights (a
  normal truncated at two deviations, scaled so its std is
  1/sqrt(fan_in)) and zero biases.

Under both laws norms are 1/0; embeddings, the CLS and positional tokens
and the numerical embedder's tables are N(0, 1) (the JAX models' own
``normal(1.0)`` initializers, which neither law re-draws); the Mamba SSM
parameters follow their own laws (``MambaBlock.reset_ssm_parameters``).

fan_in is JAX's for every kernel: the product of the flax kernel's shape
but its last axis, i.e. in-features x window.  For a ``ConvTranspose3d``
weight ``(I, O, k, k, k)`` that is 27 * I, not torch's 27 * O: the JAX
package draws its decoder deconvs with the in-channels fan as a design
choice (its module docstring), and the port follows it.
"""

from __future__ import annotations

import torch
from torch import nn

LAWS = ("torch", "flax")
# std of a standard normal truncated to [-2, 2] (flax's lecun_normal
# divides by it so the truncated draw keeps the intended variance)
_TRUNC_STD = 0.87962566103423978
_TOKENS = ("cls_token", "pos_embedding", "weights", "biases")


def check_law(law: str) -> str:
    if law not in LAWS:
        raise ValueError(f"init law must be 'torch' or 'flax', got {law!r}")
    return law


def kernel_fan_in(module: nn.Module) -> int:
    """fan_in of ``module.weight`` in the flax kernel layout."""
    w = module.weight
    if isinstance(module, nn.ConvTranspose3d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 law: str = "torch") -> None:
    """Fill every parameter of ``model`` from ``generator`` (a CPU
    generator: the draws are made on the CPU and copied, so a seed gives
    the same weights on every device) under ``law``."""
    from gfe_mamba_torch.models.mamba import MambaBlock, RMSNorm
    from gfe_mamba_torch.ops.blocks import GroupNorm

    check_law(law)
    norms = (nn.LayerNorm, GroupNorm, RMSNorm)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, norms):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif isinstance(mod, nn.Embedding) or name in _TOKENS:
                p.copy_(torch.randn(p.shape, generator=generator))
            elif name in ("weight", "bias"):
                std = kernel_fan_in(mod) ** -0.5
                if law == "torch":
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * std) - std)
                elif name == "weight":
                    std /= _TRUNC_STD
                    draw = torch.empty(p.shape)
                    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    p.copy_(draw)
                else:
                    p.zero_()
    for mod in model.modules():
        if isinstance(mod, MambaBlock):
            mod.reset_ssm_parameters(generator)
