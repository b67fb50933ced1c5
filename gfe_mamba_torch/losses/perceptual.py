"""Perceptual (LPIPS-style) loss with 2.5D slicing (counterpart of
``gfe_mamba_tpu/losses/perceptual.py``).

Slices a fraction of each axis of both volumes, pushes the 2D slices
through a frozen SqueezeNet-1.1 feature trunk, and sums over its five
taps the spatial mean of the squared difference of the channel-normalised
features; the three axes are averaged.  The trunk is seeded-random, as in
the JAX package, or read from ``weights_path``: the npz of
``{"params": tree}`` that ``tools/convert_squeezenet.py`` writes and the
JAX loss reads, carried across by ``utils.convert.state_dict_from_jax``.

Traps kept from the JAX package: conv1 is VALID with stride 2; the max
pools are VALID (``ceil_mode=False``, unlike torchvision's SqueezeNet);
expand3x3 pads by 1; 1-channel slices repeat to 3 channels; the channel
normalisation's eps is 1e-10; slices under 32 px are upsampled with
half-pixel bilinear interpolation (``jax.image.resize`` 'linear' on an
upscale); and the slice indices are exactly those of
``jnp.linspace(0, n - 1, take).astype(int32)`` on XLA:CPU
(:func:`linspace_indices`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch import resolve_device
from gfe_mamba_torch.utils.convert import state_dict_from_jax


class Fire(nn.Module):
    """squeeze 1x1 -> relu -> [expand 1x1, expand 3x3 (pad 1)] -> relu,
    concatenated on channels."""

    def __init__(self, in_channels: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_channels, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], dim=1)


class SqueezeFeatures(nn.Module):
    """SqueezeNet-1.1 trunk; ``forward`` takes channels-first images and
    returns its five feature taps, channels-first."""

    _FIRES = ((64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
              (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2)
        for i, (cin, sq, ex) in enumerate(self._FIRES, start=1):
            self.add_module(f"fire{i}", Fire(cin, sq, ex))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's Conv init, drawn from ``generator``: lecun_normal
        (truncated normal, std sqrt(1/fan_in) / 0.8796) kernels, zero
        biases."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                # 0.8796: the std of a unit normal truncated at +-2
                std = (1.0 / mod.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        x = F.relu(self.conv1(x))
        taps.append(x)
        for stage in ((1, 2), (3, 4), (5, 6), (7, 8)):
            if stage[0] < 7:
                x = F.max_pool2d(x, 3, 2)
            for i in stage:
                x = getattr(self, f"fire{i}")(x)
            taps.append(x)
        return taps


def linspace_indices(n: int, take: int) -> torch.Tensor:
    """``jnp.linspace(0, n - 1, take).astype(int32)`` as XLA:CPU computes
    it: the jitted ``linspace`` multiplies the iota by the f32 constant
    ``(n - 1) * (1 / (take - 1))`` (division turned into a reciprocal and
    the constants folded) and ends on n - 1 exactly.  Plain f32
    ``arange * (n - 1) / (take - 1)`` picks other slices in some 10% of
    the cases (e.g. slice 106 where JAX picks 105 at n = 160, take 40)."""
    if take == 1:
        return torch.zeros(1, dtype=torch.long)
    f32 = torch.float32
    step = torch.tensor(n - 1, dtype=f32) * (
        torch.tensor(1.0, dtype=f32) / torch.tensor(take - 1, dtype=f32))
    out = torch.arange(take - 1, dtype=f32) * step
    return torch.cat([out.long(), torch.tensor([n - 1])])


def _normalize_channels(feat: torch.Tensor, eps: float = 1e-10):
    return feat / (torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
                   + eps)


class PerceptualLoss(nn.Module):
    """``loss = PerceptualLoss()(pred, target)`` over channels-last
    volumes ``(B, X, Y, Z, C)``.  The feature trunk is frozen; its
    weights come from ``weights_path`` when given (module docstring),
    else from ``seed``, and it lives on ``device`` (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, fake_3d_ratio: float = 0.25, seed: int = 0,
                 device=None, weights_path: str | None = None):
        super().__init__()
        self.fake_3d_ratio = fake_3d_ratio
        self.net = SqueezeFeatures()
        if weights_path:
            with np.load(weights_path, allow_pickle=True) as loaded:
                tree = loaded["params"].item()
            self.net.load_state_dict(state_dict_from_jax(tree))
        else:
            self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.requires_grad_(False)
        self.to(resolve_device(device))

    def _lpips_2d(self, pred: torch.Tensor, target: torch.Tensor):
        """Channels-last slices ``(N, h, w, C)`` -> the summed tap
        distances."""
        pred, target = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
        h, w = pred.shape[2:]
        if min(h, w) < 32:
            scale = 32 / min(h, w)
            size = (max(32, int(h * scale)), max(32, int(w * scale)))
            pred = F.interpolate(pred, size, mode="bilinear",
                                 align_corners=False)
            target = F.interpolate(target, size, mode="bilinear",
                                   align_corners=False)
        if pred.shape[1] == 1:
            pred, target = pred.repeat(1, 3, 1, 1), target.repeat(1, 3, 1, 1)
        total = 0.0
        for a, b in zip(self.net(pred), self.net(target)):
            diff = (_normalize_channels(a) - _normalize_channels(b)) ** 2
            total = total + torch.mean(torch.sum(diff, dim=1))
        return total

    def _slices(self, vol: torch.Tensor, axis: int) -> torch.Tensor:
        """Evenly strided 2D slices along spatial ``axis`` -> a batch of
        ``(h, w, C)`` images."""
        dim = axis + 1
        n = vol.shape[dim]
        take = max(1, int(n * self.fake_3d_ratio))
        idx = linspace_indices(n, take).to(vol.device)
        sl = torch.index_select(vol, dim, idx).movedim(dim, 1)
        return sl.reshape((-1,) + sl.shape[2:])

    def forward(self, pred: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        if pred.dim() != 5:
            raise ValueError("expected (B, X, Y, Z, C) volumes")
        total = 0.0
        for axis in range(3):
            total = total + self._lpips_2d(self._slices(pred, axis),
                                           self._slices(target, axis))
        return total / 3.0
