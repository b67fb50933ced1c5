"""Fused GroupNorm + activation over a channels-last volume (counterpart
of ``gfe_mamba_tpu/ops/pallas/group_norm.py``).

The forward takes two kernels: K5a sums x and x^2 per (batch, channel),
a few hundred floats are folded into group statistics here, in PyTorch
(``var = E[x^2] - mean^2``, the one-pass formula of the kernel path), and
K5b normalises, applies the affine and the activation in one sweep.  As
in the JAX package, no model routes its GroupNorms through this function,
and the backward is the VJP of the two-pass ``_reference``: there is no
backward kernel.
"""

from __future__ import annotations

import torch
from torch.func import vjp

from gfe_mamba_torch.ops.cuda.group_norm import (act_plain,
                                                 group_norm_apply_cuda,
                                                 group_norm_apply_plain,
                                                 group_norm_sums_cuda,
                                                 group_norm_sums_plain)

__all__ = ["GroupNormActFn", "fold_group_stats", "group_norm_act"]


def fold_group_stats(sums: torch.Tensor, rows: int, num_groups: int,
                     eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel sums ``(B, 2, C)`` over ``rows`` rows -> each channel's
    group mean and rsqrt(var + eps), both ``(B, C)`` f32, with the
    one-pass var = E[x^2] - mean^2 and no clamp, as the JAX package folds
    its kernel's sums."""
    B, _, C = sums.shape
    gsize = C // num_groups
    count = float(rows * gsize)
    per_group = sums.reshape(B, 2, num_groups, gsize).sum(-1)    # (B, 2, G)
    mean_g = per_group[:, 0] / count
    var_g = per_group[:, 1] / count - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    return (mean_g.repeat_interleave(gsize, dim=-1).contiguous(),
            inv_g.repeat_interleave(gsize, dim=-1).contiguous())


def _forward(x, scale, bias, num_groups, eps, act):
    """K5a, the group fold, K5b (``_forward`` of the JAX package)."""
    B, C = x.shape[0], x.shape[-1]
    xv = x.reshape(B, -1, C).contiguous()
    sums = (group_norm_sums_cuda if x.is_cuda else group_norm_sums_plain)(xv)
    mean_c, inv_c = fold_group_stats(sums, xv.shape[1], num_groups, eps)
    apply = group_norm_apply_cuda if x.is_cuda else group_norm_apply_plain
    y = apply(xv, mean_c, inv_c, scale.float().contiguous(),
              bias.float().contiguous(), act)
    return y.reshape(x.shape)


def _reference(x, scale, bias, num_groups, eps, act):
    """Two-pass GroupNorm + act in f32, cast back to x's dtype (the JAX
    package's ``_reference``; elu through expm1, as ``jax.nn.elu``)."""
    B, C = x.shape[0], x.shape[-1]
    gsize = C // num_groups
    xg = x.float().reshape(B, -1, num_groups, gsize)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = (xg - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, -1, C) * scale + bias
    if act == "elu":
        y = torch.where(y > 0, y, torch.expm1(torch.clamp(y, max=0.0)))
    else:
        y = act_plain(y, act)
    return y.reshape(x.shape).to(x.dtype)


class GroupNormActFn(torch.autograd.Function):
    """K5a + fold + K5b forward on CUDA tensors (the plain versions on CPU
    ones); the backward is the VJP of ``_reference`` at the saved x,
    scale and bias, as ``_vjp_bwd`` in the JAX package."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (num_groups, eps, act)
        return _forward(x, scale, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        _, pullback = vjp(lambda *a: _reference(*a, *ctx.config),
                          x, scale, bias)
        return (*pullback(g), None, None, None)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   *, num_groups: int, eps: float = 1e-5,
                   act: str = "none") -> torch.Tensor:
    """Fused GroupNorm + activation over channels-last ``x`` ``(B, ...,
    C)`` with per-channel ``scale`` and ``bias``.

    act: 'none' | 'elu' | 'relu' | 'leaky_relu' (slope 0.01); any other
    name is the identity, as in the JAX function.  CUDA tensors go through
    K5a and K5b (f32 or bf16 x); CPU tensors through their plain
    versions."""
    C = x.shape[-1]
    assert C % num_groups == 0, (C, num_groups)
    return GroupNormActFn.apply(x, scale, bias, num_groups, eps, act)
