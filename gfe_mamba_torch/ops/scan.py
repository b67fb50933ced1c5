"""Selective scan for the Mamba layers (counterpart of
``gfe_mamba_tpu/ops/scan.py`` and the custom VJP of
``ops/pallas/selective_scan.py``)."""

from __future__ import annotations

import torch

from gfe_mamba_torch.ops.cuda.selective_scan import (selective_scan_bwd_cuda,
                                                     selective_scan_bwd_plain,
                                                     selective_scan_cuda,
                                                     selective_scan_plain)


def _f32(t):
    return None if t is None else t.float().contiguous()


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its backward: forward through K2 on CUDA tensors and
    the plain loop on CPU ones; backward through K4 or
    ``selective_scan_bwd_plain``.  It saves the f32 inputs, not h: the
    backward recomputes the states, as ``_vjp_fwd`` in the JAX package
    does.  Each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, delta, A, B, C, D, z, delta_bias, delta_softplus):
        args = [_f32(t) for t in (x, delta, A, B, C, D, z, delta_bias)]
        ctx.dtypes = [None if t is None else t.dtype
                      for t in (x, delta, A, B, C, D, z, delta_bias)]
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(*args)
        scan = selective_scan_cuda if x.is_cuda else selective_scan_plain
        return scan(*args, delta_softplus=delta_softplus).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        bwd = selective_scan_bwd_cuda if g.is_cuda else selective_scan_bwd_plain
        grads = bwd(*args, _f32(g), delta_softplus=ctx.delta_softplus)
        return (*(None if d is None else d.to(dt)
                  for d, dt in zip(grads, ctx.dtypes)), None)


def selective_scan(x, delta, A, B, C, D, z=None, delta_bias=None,
                   delta_softplus=False) -> torch.Tensor:
    """Fused selective scan with the mamba_ssm ``selective_scan_fn``
    contract: x, delta, z ``(B, L, ED)``; A ``(ED, N)``; B, C
    ``(B, L, N)``; D, delta_bias ``(ED,)``.  Returns y ``(B, L, ED)`` in
    x's dtype.

    Every input is cast to f32 and the recurrence runs in f32, whatever
    the surrounding dtype.  CUDA tensors go through K2 (K4 backward); CPU
    tensors through the sequential plain loops."""
    return SelectiveScanFn.apply(x, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus)
