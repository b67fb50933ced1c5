"""K5a and K5b: the GroupNorm statistics and apply kernels
(``csrc/group_norm.cu``), each with its plain PyTorch version.

Both take x as ``(B, S, C)``, channels-last and contiguous, in f32 or
bf16.  K5a returns the per-(batch, channel) sums ``(B, 2, C)`` in f32:
``[:, 0]`` is sum_s x, ``[:, 1]`` sum_s x^2.  K5b computes, in f32 and in
this order::

    y = (x - mean[b, c]) * inv[b, c] * scale[c] + bias[c]
    y = act(y)          none | elu | relu | leaky_relu (slope 0.01)

and stores y in x's dtype; mean and inv are ``(B, C)`` f32, scale and bias
``(C,)`` f32.  ``*_cuda`` launch the kernels on CUDA tensors and raise on
anything else; ``*_plain`` are the same functions op by op, for CPU
tensors and the on-card checks.
"""

from __future__ import annotations

import ctypes

import torch

from gfe_mamba_torch.ops.cuda.conv3d import ACT_CODES, apply_act

# K5's act names -> the fused conv's (whose codes the kernel shares); any
# other name is the identity, as in the JAX package
_ACTS = {"elu": "elu", "relu": "relu", "leaky_relu": "leaky001"}
# both kernels split each batch row's S rows over blocks: about this many
# blocks in all, each split at least _MIN_ROWS rows
_BLOCKS = 1024
_MIN_ROWS = 256

# kernel launches since the counters were last set to 0: K5a, K5b
stats_launches = 0
apply_launches = 0


def act_plain(y: torch.Tensor, act: str) -> torch.Tensor:
    """The kernel's activation on f32 ``y``; unknown names pass y."""
    return apply_act(y, _ACTS.get(act, "none"))


def group_norm_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain K5a: ``(B, 2, C)`` f32 sums of x and x^2 over dim 1."""
    xf = x.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


def group_norm_apply_plain(x, mean, inv, scale, bias, act="none"):
    """Plain K5b: the normalisation, affine and activation in f32,
    rounded once to x's dtype."""
    y = (x.float() - mean[:, None, :]) * inv[:, None, :] * scale + bias
    return act_plain(y, act).to(x.dtype)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, x is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_x(x) -> tuple[int, int, int]:
    if not x.is_cuda:
        raise ValueError("the group-norm kernels take CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group-norm kernels: unsupported dtype {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    B, S, C = x.shape
    if B > 65535 or S >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError(f"x of shape {tuple(x.shape)} is out of range")
    return B, S, C


def _splits(B: int, S: int) -> tuple[int, int]:
    """(splits, rows per split): no split is empty."""
    splits = max(1, min(-(-_BLOCKS // B), -(-S // _MIN_ROWS)))
    rows = -(-S // splits)
    return -(-S // rows), rows


def group_norm_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K5a; returns ``(B, 2, C)`` f32.  The kernel writes one f32
    partial per (batch, split); the sum over the splits runs here, in a
    fixed order, so the result is deterministic."""
    from gfe_mamba_torch.ops.cuda.build import library

    global stats_launches
    B, S, C = _check_x(x)
    if x.numel() == 0:
        return torch.zeros(B, 2, C, dtype=torch.float32, device=x.device)
    splits, rows = _splits(B, S)
    part = torch.empty(B, splits, 2, C, dtype=torch.float32, device=x.device)
    fn = library("group_norm").gfe_group_norm_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(),
                part.data_ptr(), B, S, C, splits, rows, stream)
    if rc != 0:
        raise RuntimeError(f"group_norm stats kernel failed: CUDA error {rc}")
    stats_launches += 1
    return part.sum(1)


def group_norm_apply_cuda(x, mean, inv, scale, bias, act="none"):
    """Launch K5b on x ``(B, S, C)``; returns y of x's shape and dtype."""
    from gfe_mamba_torch.ops.cuda.build import library

    global apply_launches
    B, S, C = _check_x(x)
    f32 = torch.float32
    _check("mean", mean, (B, C), f32, x.device)
    _check("inv", inv, (B, C), f32, x.device)
    _check("scale", scale, (C,), f32, x.device)
    _check("bias", bias, (C,), f32, x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    splits, rows = _splits(B, S)
    fn = library("group_norm").gfe_group_norm_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(),
                mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, S, C, splits, rows,
                ACT_CODES[_ACTS.get(act, "none")], stream)
    if rc != 0:
        raise RuntimeError(f"group_norm apply kernel failed: CUDA error {rc}")
    apply_launches += 1
    return out
