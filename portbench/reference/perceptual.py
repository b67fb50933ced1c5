"""The 2.5D perceptual loss of GFE-Mamba's Stage 1 (MONAI's
``PerceptualLoss`` with ``fake_3d_ratio``, over a SqueezeNet-1.1 trunk):
for each spatial axis, an evenly strided quarter of the slices of both
volumes, repeated to 3 channels (upsampled bilinearly, half-pixel,
where under 32 px), through the trunk; at each of its five taps the
features are normalised over channels (eps 1e-10) and the spatial mean
of their summed squared difference is taken; the taps are summed and the
axes averaged.

The trunk: conv 3x3 stride 2 (no padding) + ReLU, then max pools (3,
stride 2, no padding) before fire modules 1-2, 3-4 and 5-6, and fire
modules 7-8 without a pool; a fire module squeezes with a 1x1 conv +
ReLU and concatenates a 1x1 and a 3x3 (padding 1) expansion, each +
ReLU.  The slice indices are ``linspace(0, n - 1, take)`` truncated, the
float32 way: each index i * ((n - 1) * (1 / (take - 1))), the last n - 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F



def linspace_indices(n: int, take: int) -> torch.Tensor:
    if take == 1:
        return torch.zeros(1, dtype=torch.long)
    f32 = torch.float32
    step = torch.tensor(n - 1, dtype=f32) * (
        torch.tensor(1.0, dtype=f32) / torch.tensor(take - 1, dtype=f32))
    out = torch.arange(take - 1, dtype=f32) * step
    return torch.cat([out.long(), torch.tensor([n - 1])])


def _conv(P, name, x, q, stride=1, padding=0):
    return q.out(F.conv2d(q(x), q(P[f"{name}.weight"]), stride=stride,
                          padding=padding)) \
        + P[f"{name}.bias"].float().reshape(1, -1, 1, 1)


def trunk(P, x, q):
    taps = []
    x = F.relu(_conv(P, "conv1", x, q, stride=2))
    taps.append(x)
    for stage in ((1, 2), (3, 4), (5, 6), (7, 8)):
        if stage[0] < 7:
            x = F.max_pool2d(x, 3, 2)
        for i in stage:
            s = F.relu(_conv(P, f"fire{i}.squeeze", x, q))
            x = torch.cat([F.relu(_conv(P, f"fire{i}.expand1x1", s, q)),
                           F.relu(_conv(P, f"fire{i}.expand3x3", s, q,
                                        padding=1))], dim=1)
        taps.append(x)
    return taps


def _normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def _slices(vol, axis, ratio):
    dim = axis + 1
    n = vol.shape[dim]
    idx = linspace_indices(n, max(1, int(n * ratio))).to(vol.device)
    sl = torch.index_select(vol, dim, idx).movedim(dim, 1)
    return sl.reshape((-1,) + sl.shape[2:]).permute(0, 3, 1, 2)


def perceptual(P, pred, target, ratio, q):
    """``pred`` and ``target``: channels-last volumes ``(B, X, Y, Z, C)``."""
    total = 0.0
    for axis in range(3):
        a, b = _slices(pred.float(), axis, ratio), \
            _slices(target.float(), axis, ratio)
        h, w = a.shape[2:]
        if min(h, w) < 32:
            scale = 32 / min(h, w)
            size = (max(32, int(h * scale)), max(32, int(w * scale)))
            a = F.interpolate(a, size, mode="bilinear", align_corners=False)
            b = F.interpolate(b, size, mode="bilinear", align_corners=False)
        if a.shape[1] == 1:
            a, b = a.repeat(1, 3, 1, 1), b.repeat(1, 3, 1, 1)
        for fa, fb in zip(trunk(P, a, q), trunk(P, b, q)):
            diff = (_normalize(fa) - _normalize(fb)) ** 2
            total = total + torch.mean(torch.sum(diff, dim=1))
    return total / 3.0
