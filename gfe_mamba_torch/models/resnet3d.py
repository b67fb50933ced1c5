"""The Kinetics-style 3D ResNet family, depths 10 to 200 (counterpart of
``gfe_mamba_tpu/models/resnet3d.py``; reference
pytorch3dunet/threedresnet.py:102-233), channels-last ``(B, X, Y, Z, C)``
at its boundary.

Module names are the reference's (``conv1``, ``bn1``, ``layer<s>.<b>.
conv1``, ``...downsample.0`` / ``.1``, ``fc``), so a state dict of the
``r3d101_KM_200ep`` checkpoint's form loads by name;
``utils/convert.py`` maps the JAX package's flax names (``layer<s>_<b>``,
``downsample``, ``downsample_bn``) onto them.  The temporal axis of the
stem, ``conv1_t_size`` / ``conv1_t_stride``, is the last spatial axis Z.
The BatchNorms are flax's (``ops/blocks.py``: momentum 0.99, the biased
batch variance).  The convs are cuDNN's, as XLA's are in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gfe_mamba_torch.ops.blocks import BatchNorm
from gfe_mamba_torch.ops.conv3d import on_channels_first as _conv


def _downsample(in_planes: int, out_planes: int, stride: int):
    """The 1x1x1 strided projection and its BatchNorm of a residual
    branch whose stride or width changes, else None."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(nn.Conv3d(in_planes, out_planes, 1, stride=stride,
                                   bias=False), BatchNorm(out_planes))


def _residual(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if block.downsample is None:
        return x
    return block.downsample[1](_conv(block.downsample[0], x))


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(in_planes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = _downsample(in_planes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = self.bn2(_conv(self.conv2, y))
        return F.relu(y + _residual(self, x))


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv3d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv3d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm(out_planes)
        self.downsample = _downsample(in_planes, out_planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        return F.relu(y + _residual(self, x))


class ResNet3D(nn.Module):
    """Stem conv (7, 7, conv1_t_size) + BatchNorm + relu, a 3x3x3 stride-2
    max pool (padded with -inf) unless ``no_max_pool``, four stages of
    blocks (the first block of stages 2-4 strides by 2), global average
    pool, and ``fc`` unless ``feature_only``."""

    def __init__(self, block: str, layers: Sequence[int],
                 block_inplanes: Sequence[int] = (64, 128, 256, 512),
                 n_classes: int = 1039, n_input_channels: int = 3,
                 conv1_t_size: int = 7, conv1_t_stride: int = 1,
                 no_max_pool: bool = False, widen_factor: float = 1.0,
                 feature_only: bool = False):
        super().__init__()
        block_cls = BasicBlock3D if block == "basic" else Bottleneck3D
        planes = [int(p * widen_factor) for p in block_inplanes]
        self.no_max_pool = no_max_pool
        self.conv1 = nn.Conv3d(n_input_channels, planes[0],
                               (7, 7, conv1_t_size),
                               stride=(2, 2, conv1_t_stride),
                               padding=(3, 3, conv1_t_size // 2), bias=False)
        self.bn1 = BatchNorm(planes[0])
        in_planes = planes[0]
        for stage, (n_blocks, width) in enumerate(zip(layers, planes)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block_cls(in_planes, width, stride))
                in_planes = width * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)
        self.fc = None if feature_only else nn.Linear(in_planes, n_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The globally pooled features ``(B, C)`` that ``fc`` reads."""
        x = F.relu(self.bn1(_conv(self.conv1, x)))
        if not self.no_max_pool:
            x = _conv(lambda t: F.max_pool3d(t, 3, 2, 1), x)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean((1, 2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return x if self.fc is None else self.fc(x)


_DEPTH_SPECS = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def generate_model(model_depth: int, **kwargs) -> ResNet3D:
    """The ResNet3D of ``model_depth`` in {10, 18, 34, 50, 101, 152, 200}
    (threedresnet.py:199-233); ``kwargs`` go to :class:`ResNet3D`."""
    if model_depth not in _DEPTH_SPECS:
        raise ValueError(f"model_depth must be one of {sorted(_DEPTH_SPECS)}")
    block, layers = _DEPTH_SPECS[model_depth]
    return ResNet3D(block, layers, **kwargs)
