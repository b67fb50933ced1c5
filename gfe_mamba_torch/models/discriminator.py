"""PatchGAN discriminator of the Stage-1 GAN (counterpart of
``gfe_mamba_tpu/models/discriminator.py``), 3D or, with ``dims=2``, 2D,
channels-last at its boundary.

  conv(k4, s2) + LeakyReLU(0.2)                          [no norm]
  x (num_layers_d - 1): conv(k4, s2) + InstanceNorm + LeakyReLU(0.2)
  conv(k4, s1) + InstanceNorm + LeakyReLU(0.2)           [channels x2]
  conv(k4, s1) -> patch logits

``forward`` returns the list of features with the logits last.  The
convs are cuDNN's (the JAX package leaves them to XLA, not Pallas); each
pads explicitly as ``_padding`` does there, (1, 1) widened on the high
side so that toy volumes keep one output sample.  Instance norm is flax's
``GroupNorm(group_size=1)``: eps 1e-6 and var = E[x^2] - E[x]^2, so that
a single-voxel map normalises to 0 as in JAX (torch's ``group_norm``
refuses one).  The space-to-depth lowering of the JAX package is a TPU
device and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.ops.blocks import InstanceNorm


def _pad(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """(1, max(1, kernel - n - 1)) per spatial dim of a channels-first
    map."""
    pads = []
    for n in reversed(x.shape[2:]):
        pads += [1, max(1, kernel - n - 1)]
    return F.pad(x, pads)


class PatchDiscriminator(nn.Module):
    def __init__(self, num_layers_d: int = 3, num_channels: int = 32,
                 in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 4, dims: int = 3):
        super().__init__()
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        self.num_layers_d = num_layers_d
        self.kernel_size = kernel_size
        conv = nn.Conv3d if dims == 3 else nn.Conv2d
        k = kernel_size
        ch = num_channels
        self.conv_0 = conv(in_channels, ch, k, stride=2)
        for i in range(1, num_layers_d):
            self.add_module(f"conv_{i}", conv(ch, 2 * ch, k, stride=2,
                                              bias=False))
            ch *= 2
            self.add_module(f"norm_{i}", InstanceNorm(ch))
        self.conv_pre = conv(ch, 2 * ch, k, bias=False)
        ch *= 2
        self.norm_pre = InstanceNorm(ch)
        self.conv_out = conv(ch, out_channels, k)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """MONAI's DCGAN init, drawn from ``generator``: convs N(0, 0.02),
        norm scales N(1, 0.02), biases 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                nn.init.normal_(mod.weight, 0.0, 0.02, generator=generator)
            elif isinstance(mod, InstanceNorm):
                nn.init.normal_(mod.weight, 1.0, 0.02, generator=generator)
            if isinstance(mod, (nn.Conv2d, nn.Conv3d, InstanceNorm)) \
                    and mod.bias is not None:
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        k = self.kernel_size
        x = x.movedim(-1, 1)
        features = []
        x = F.leaky_relu(self.conv_0(_pad(x, k)), 0.2)
        features.append(x)
        for i in range(1, self.num_layers_d):
            x = getattr(self, f"conv_{i}")(_pad(x, k))
            x = F.leaky_relu(getattr(self, f"norm_{i}")(x), 0.2)
            features.append(x)
        x = F.leaky_relu(self.norm_pre(self.conv_pre(_pad(x, k))), 0.2)
        features.append(x)
        features.append(self.conv_out(_pad(x, k)))
        return [f.movedim(1, -1) for f in features]
