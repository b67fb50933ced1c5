"""3D volume ops of the generator, channels-last ``(B, X, Y, Z, C)``.

Counterpart of ``gfe_mamba_tpu/ops/pallas/conv3d.py``: the fused
GN-apply + 3x3x3 conv (K1) with its backward (K1 again for the input
gradient, K3 for the weight gradient) behind ``conv3x3x3``, plus the
helpers around it -- GroupNorm statistics, the activation set, the 2x2x2
max pool, the stride-2 transposed conv and the nearest resize -- and the
general ops of the segmentation blocks (``ops/blocks.py`` of the JAX
package) on 2D or 3D channels-last tensors: ``conv_nd`` (cuDNN's conv,
for the convs K1 does not take), ``deconv_nd``, ``pool_nd`` and
``interpolate_to`` (the floor-index nearest resize, or
``jax.image.resize``'s kernels for every other method).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gfe_mamba_torch.ops.cuda.conv3d import (apply_act, conv3x3x3_cuda,
                                             conv3x3x3_dw_cuda,
                                             conv3x3x3_dw_plain,
                                             conv3x3x3_plain)
from gfe_mamba_torch.utils.profiling import annotate

__all__ = ["Conv3x3x3Fn", "apply_act", "conv3x3x3", "conv_nd",
           "deconv3x3x3_s2", "deconv_nd", "group_norm_stats",
           "interpolate_to", "on_channels_first", "pool_nd",
           "resize_nearest"]


class _SumOfSquares(torch.autograd.Function):
    """Per-(batch, channel) sum of x^2 over dim 1 in f32 (f64 for f64
    x), reading x once in its own dtype.  The backward is 2 x g: finite
    where a channel is all zeros, where the gradient of
    ``vector_norm(x) ** 2`` is 0/0."""

    @staticmethod
    def forward(ctx, xv):
        ctx.save_for_backward(xv)
        return torch.linalg.vector_norm(
            xv, 2, dim=1,
            dtype=torch.promote_types(xv.dtype, torch.float32)).square()

    @staticmethod
    def backward(ctx, g):
        xv, = ctx.saved_tensors
        return (2.0 * g[:, None, :] * xv).to(xv.dtype)


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """Per-(batch, channel) ``(mu, rstd)`` of each channel's group, both
    ``(B, C)`` f32 (f64 for f64 x): per-channel means of x and x^2 first,
    then averaged within each group, var = E[x^2] - mu^2.

    Both sums read x once in its own dtype and accumulate in f32 (f64);
    an f32 copy of a full-resolution bf16 volume would cost 4x the
    traffic."""
    B, C = x.shape[0], x.shape[-1]
    xv = x.reshape(B, -1, C)
    n = xv.shape[1]
    mu_c = torch.sum(xv, dim=1,
                     dtype=torch.promote_types(x.dtype, torch.float32)) / n
    ex2_c = _SumOfSquares.apply(xv) / n
    per = C // num_groups
    mu = mu_c.reshape(B, num_groups, per).mean(-1)
    ex2 = ex2_c.reshape(B, num_groups, per).mean(-1)
    rstd = torch.rsqrt(ex2 - mu * mu + eps)
    return (mu.repeat_interleave(per, dim=-1),
            rstd.repeat_interleave(per, dim=-1))


def deconv3x3x3_s2(x: torch.Tensor, weight: torch.Tensor,
                   exact_2n: bool = True) -> torch.Tensor:
    """k=3, stride-2 transposed conv.  ``exact_2n`` emits exactly 2n
    samples per axis (the semantics of ``deconv3x3x3_s2_packed``); without
    it, 2n-1 (flax ``ConvTranspose`` with padding (1, 1), the JAX
    decoder's path for an odd z extent).

    ``weight`` is the torch ``ConvTranspose3d`` layout ``(I, O, 3, 3, 3)``,
    i.e. the flax kernel flipped spatially (``torch_import._deconv``)."""
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), weight.to(x.dtype),
                           stride=2, padding=1,
                           output_padding=1 if exact_2n else 0)
    return y.permute(0, 2, 3, 4, 1)


def resize_nearest(x: torch.Tensor, spatial) -> torch.Tensor:
    """Nearest resize of a channels-last volume to ``spatial`` with the
    torch ``F.interpolate`` index rule idx = floor(i * in / out), computed
    in f32 (``_interpolate_to`` of the JAX package)."""
    for axis, size in enumerate(spatial, start=1):
        n = x.shape[axis]
        if n == size:
            continue
        idx = torch.floor(torch.arange(size, dtype=torch.float32)
                          * (n / size)).long()
        x = torch.index_select(x, axis, idx.to(x.device))
    return x


def on_channels_first(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a channels-first tensor (a torch conv or pool) applied
    to channels-last ``x``; the result channels-last again, a view of
    ``fn``'s channels-first output."""
    return fn(x.movedim(-1, 1)).movedim(1, -1)


def conv_nd(x: torch.Tensor, weight: torch.Tensor, bias=None,
            padding=1) -> torch.Tensor:
    """Stride-1 conv of a channels-last ``(B, *spatial, C)`` tensor (2D
    or 3D) through cuDNN (``F.conv2d`` / ``F.conv3d``): the convs of the
    segmentation blocks that K1 does not take.  ``weight`` is the torch
    layout ``(O, I, *k)``; ``padding`` an int, a tuple or 'SAME' /
    'VALID' (flax's names)."""
    conv = F.conv3d if x.dim() == 5 else F.conv2d
    if isinstance(padding, str):
        padding = padding.lower()
    bias = None if bias is None else bias.to(x.dtype)
    return on_channels_first(
        lambda t: conv(t, weight.to(x.dtype), bias, padding=padding),
        x).contiguous()


def deconv_nd(x: torch.Tensor, weight: torch.Tensor,
              stride: int) -> torch.Tensor:
    """flax ``ConvTranspose(k, strides=stride, padding=(1, 1) per axis)``
    of a channels-last tensor: (n - 1) * stride + 4 - k samples per axis
    (2n - 1 at k = 3, stride 2).  ``weight`` is the torch layout ``(I, O,
    *k)``, the flax kernel flipped spatially."""
    conv = F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d
    k = weight.shape[-1]
    # the full transposed conv pads the dilated input by k - 1 per side,
    # flax's by 1: take k - 2 off each side (or add zeros when k = 1)
    return on_channels_first(
        lambda t: F.pad(conv(t, weight.to(x.dtype), stride=stride),
                        [2 - k] * (2 * (x.dim() - 2))), x).contiguous()


def pool_nd(x: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    """``kind`` ('max' or 'avg') pool of a channels-last tensor, window
    and stride ``k`` per spatial axis, VALID."""
    dims = x.dim() - 2
    fn = {("max", 2): F.max_pool2d, ("max", 3): F.max_pool3d,
          ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}[kind, dims]
    return on_channels_first(lambda t: fn(t, k, k), x).contiguous()


def _triangle(d):
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(d):
        y = radius * torch.sin(math.pi * d) * torch.sin(math.pi * d / radius)
        out = torch.where(d > 1e-3, y / torch.where(
            d != 0, math.pi ** 2 * d ** 2, torch.ones_like(d)), 1.0)
        return torch.where(d > radius, 0.0, out)
    return kernel


_RESIZE_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                    _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _resize_weights(n_in: int, n_out: int, kernel) -> torch.Tensor:
    """``(n_in, n_out)`` f32 weights of ``jax.image.resize`` along one
    axis (``compute_weight_mat``, antialiased, no translation)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) \
        * inv_scale - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = kernel(d)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate_to(x: torch.Tensor, spatial, method: str) -> torch.Tensor:
    """Resize channels-last ``x`` to the spatial extents ``spatial``
    (``_interpolate_to`` of the JAX package): 'nearest' by the floor-index
    rule of :func:`resize_nearest`, any other method as
    ``jax.image.resize`` computes it (separable weights per axis, in x's
    dtype)."""
    if tuple(x.shape[1:-1]) == tuple(spatial):
        return x
    if method == "nearest":
        return resize_nearest(x, spatial)
    try:
        kernel = _RESIZE_KERNELS[method]
    except KeyError:
        raise ValueError(f"unknown resize method {method!r}") from None
    for axis, size in enumerate(spatial, start=1):
        n = x.shape[axis]
        if n == size:
            continue
        w = _resize_weights(n, size, kernel).to(x.device, x.dtype)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x.contiguous()


def _act_grad_from_out(y: torch.Tensor, act: str):
    """act'(y0) recovered from y = act(y0) (``_act_grad_from_out`` of the
    JAX package): relu/leaky from the sign, elu from exp(y0) = y + 1."""
    if act == "none":
        return None
    if act == "relu":
        return (y > 0).to(y.dtype)
    if act == "elu":
        return torch.where(y > 0, torch.ones_like(y), y + 1.0)
    if act == "leaky01":
        return torch.where(y > 0, 1.0, 0.1).to(y.dtype)
    if act == "leaky001":
        return torch.where(y > 0, 1.0, 0.01).to(y.dtype)
    raise ValueError(f"unknown activation {act!r}")


class Conv3x3x3Fn(torch.autograd.Function):
    """The fused conv with its backward (``_fwd_p``/``_bwd_p`` of the JAX
    package, without the z-pair packing).

    It saves the output, not the pre-activation: act' and post_act' come
    back from the output, which is exact because act excludes a
    residual/post_act epilogue.  With g2 = g * post_act' and
    g1 = g2 * act': the input gradient of the conv is
    dz = conv3x3x3(g1, w flipped and transposed) (K1 on the card), the
    weight gradient dw comes from K3 (the 27-tap plain version on the
    CPU), and the rest are reductions: dbias = sum g1, da = sum dz * x
    and ds = sum dz per (batch, channel), dx = dz * a, dres = g2."""

    @staticmethod
    def forward(ctx, x, w, bias, pre_scale, pre_shift, residual, act,
                post_act):
        conv = conv3x3x3_cuda if x.is_cuda else conv3x3x3_plain
        out = conv(x, w, bias, pre_scale, pre_shift, residual, act, post_act)
        ctx.save_for_backward(x, w, bias, pre_scale, pre_shift, residual,
                              out)
        ctx.acts = (act, post_act)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, bias, pre_scale, pre_shift, residual, out = ctx.saved_tensors
        act, post_act = ctx.acts
        need = ctx.needs_input_grad
        g = g.to(x.dtype)
        pag = _act_grad_from_out(out, post_act)
        g2 = g if pag is None else g * pag
        ag = _act_grad_from_out(out, act)
        g1 = g2 if ag is None else g2 * ag
        dx = dw = dbias = da = ds = None
        if need[0] or need[3] or need[4]:
            with annotate("gfe.conv3d.dz"):
                wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
                conv = conv3x3x3_cuda if g1.is_cuda else conv3x3x3_plain
                dz = conv(g1.contiguous(), wf)
            if need[0]:
                dx = dz if pre_scale is None else \
                    dz * pre_scale.to(dz.dtype)[:, None, None, None, :]
            if need[3]:
                da = (dz.float() * x.float()).sum((1, 2, 3))
            if need[4]:
                ds = dz.float().sum((1, 2, 3))
        if need[1]:
            dw_fn = conv3x3x3_dw_cuda if x.is_cuda else conv3x3x3_dw_plain
            with annotate("gfe.conv3d.dw"):
                dw = dw_fn(x, g1.contiguous(), pre_scale, pre_shift
                           ).to(w.dtype)
        if need[2]:
            dbias = g1.float().sum((0, 1, 2, 3)).to(bias.dtype)
        dres = g2 if need[5] else None
        return dx, dw, dbias, da, ds, dres, None, None


def conv3x3x3(x, w, bias=None, pre_scale=None, pre_shift=None,
              residual=None, act="none", post_act="none"):
    """``post_act(act(conv3d(x*pre_scale + pre_shift, w) + bias)
    + residual)``: SAME, stride 1, f32 accumulation (``conv3x3x3_p``).

    CUDA tensors go through K1 (backward: K1 and K3); CPU tensors through
    the plain versions.  ``act`` may not be combined with a
    residual/post_act epilogue, the same rule as the JAX function (whose
    backward recovers act' from the saved output)."""
    if act != "none" and (residual is not None or post_act != "none"):
        raise ValueError(
            "conv3x3x3: act together with residual/post_act is unsupported")
    return Conv3x3x3Fn.apply(x, w, bias, pre_scale, pre_shift, residual, act,
                             post_act)

