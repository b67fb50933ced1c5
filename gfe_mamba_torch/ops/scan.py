"""Selective scan for the Mamba layers (counterpart of
``gfe_mamba_tpu/ops/scan.py`` and the custom VJP of
``ops/pallas/selective_scan.py``), its one-token step, and the
first-order linear recurrence on plain ops."""

from __future__ import annotations

import torch

from gfe_mamba_torch.ops.cuda.selective_scan import (kernel_operand,
                                                     selective_scan_bwd_cuda,
                                                     selective_scan_bwd_plain,
                                                     selective_scan_cuda,
                                                     selective_scan_plain)


def linear_recurrence(coeffs: torch.Tensor, values: torch.Tensor, *,
                      axis: int = 1, mode: str = "associative") -> torch.Tensor:
    """All prefixes of ``h[t] = coeffs[t] * h[t-1] + values[t]`` with
    ``h[-1] = 0``, along ``axis``.  ``"associative"`` doubles the span
    each round (log depth) with the combine ``(a2 a1, a2 b1 + b2)``;
    ``"sequential"`` walks t."""
    if mode == "associative":
        a, b = torch.broadcast_tensors(coeffs, values)
        a, b = a.movedim(axis, 0), b.movedim(axis, 0)
        step = 1
        while step < a.shape[0]:
            b = torch.cat([b[:step], a[step:] * b[:-step] + b[step:]])
            a = torch.cat([a[:step], a[step:] * a[:-step]])
            step *= 2
        return b.movedim(0, axis)
    if mode == "sequential":
        a, b = coeffs.movedim(axis, 0), values.movedim(axis, 0)
        h, hs = torch.zeros_like(b[0]), []
        for t in range(b.shape[0]):
            h = a[t] * h + b[t]
            hs.append(h)
        return torch.stack(hs).movedim(0, axis)
    raise ValueError(f"unknown scan mode {mode!r}")


def _f32(t):
    return None if t is None else t.float().contiguous()


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its backward: forward through K2 on CUDA tensors and
    the plain loop on CPU ones; backward through K4 or
    ``selective_scan_bwd_plain``.  It saves its inputs, not h: the
    backward recomputes the states, as ``_vjp_fwd`` in the JAX package
    does.  Each gradient comes back in its input's dtype.

    On CUDA the kernels read f32 or bf16 with any strides and widen to
    f32 in registers, so the operands go in as they are (``chunk`` and
    ``split`` views, channel-major x, bf16): only another dtype is cast
    to f32 (``kernel_operand``), and A, which K2 and K4 read as f32, is
    made f32 and contiguous (already so in a Mamba layer).  y, dx, ddelta
    and dz come out of the kernels in their operands' dtypes; the f32
    dA, dB, dC, dD and ddelta_bias are cast here.  On the CPU every
    operand is cast to a contiguous f32 copy for the plain loops."""

    @staticmethod
    def forward(ctx, x, delta, A, B, C, D, z, delta_bias, delta_softplus):
        ins = (x, delta, A, B, C, D, z, delta_bias)
        ctx.dtypes = [None if t is None else t.dtype for t in ins]
        ctx.delta_softplus = delta_softplus
        if x.is_cuda:
            args = [kernel_operand(t) for t in ins]
            args[2] = A.float().contiguous()
            y = selective_scan_cuda(*args, delta_softplus=delta_softplus)
        else:
            args = [_f32(t) for t in ins]
            y = selective_scan_plain(*args, delta_softplus=delta_softplus)
        ctx.save_for_backward(*args)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if g.is_cuda:
            grads = selective_scan_bwd_cuda(
                *args, kernel_operand(g), delta_softplus=ctx.delta_softplus)
        else:
            grads = selective_scan_bwd_plain(
                *args, _f32(g), delta_softplus=ctx.delta_softplus)
        return (*(None if d is None else d.to(dt)
                  for d, dt in zip(grads, ctx.dtypes)), None)


def selective_scan(x, delta, A, B, C, D, z=None, delta_bias=None,
                   delta_softplus=False) -> torch.Tensor:
    """Fused selective scan with the mamba_ssm ``selective_scan_fn``
    contract: x, delta, z ``(B, L, ED)``; A ``(ED, N)``; B, C
    ``(B, L, N)``; D, delta_bias ``(ED,)``.  Returns y ``(B, L, ED)`` in
    x's dtype.

    The recurrence runs in f32, whatever the surrounding dtype.  CUDA
    tensors go through K2 (K4 backward), which read bf16 and strided
    operands as they are; CPU tensors are cast to f32 for the sequential
    plain loops."""
    return SelectiveScanFn.apply(x, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus)


def selective_scan_step(h, x, delta, A, B, C, D):
    """One recurrent step of the scan, plain PyTorch on any device: h
    ``(B, ED, N)`` the carried state, x and the post-softplus delta
    ``(B, ED)``, A ``(ED, N)``, B and C ``(B, N)``, D ``(ED,)``.  Returns
    ``(y (B, ED), new h)``, y without the gate."""
    h = torch.exp(delta[..., None] * A) * h \
        + (delta * x)[..., None] * B[:, None, :]
    y = torch.einsum("ben,bn->be", h, C) + D * x
    return y, h
