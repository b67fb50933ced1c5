"""K2 and K4: the selective-scan forward kernel
(``csrc/selective_scan.cu``) and its backward (``csrc/selective_scan_bwd.cu``),
each with its plain PyTorch version.

All take f32 tensors with the mamba_ssm contract: x, delta, z
``(B, L, ED)``; A ``(ED, N)``; B, C ``(B, L, N)``; D, delta_bias
``(ED,)``.  The forward returns y ``(B, L, ED)`` in f32::

    d = softplus(delta + delta_bias)            (each step optional)
    h = exp(d * A) * h + (d * x) * B_t;  y = C_t . h + D * x
    y = y * silu(z)                              (optional)

The backward takes the cotangent g of y and returns
``(dx, ddelta, dA, dB, dC, dD, dz, ddelta_bias)``, dz None without a gate
and ddelta_bias None without a bias.  ``*_cuda`` launch the kernels on
CUDA tensors; ``*_plain`` are the sequential reference loops over L.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel launches since the counters were last set to 0: K2, K4
launches = 0
bwd_launches = 0

_STATE_SIZES = (4, 8, 16, 32)
_NTHREADS = 128          # threads per block of both kernels
_MAX_SMEM = 227 * 1024


def softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(v)) without torch's threshold shortcut
    (``jax.nn.softplus``)."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def selective_scan_plain(x, delta, A, B, C, D, z=None, delta_bias=None,
                         delta_softplus=False):
    """Sequential f32 loop over L (the ``mode='sequential'`` recurrence of
    the JAX package)."""
    if delta_bias is not None:
        delta = delta + delta_bias
    if delta_softplus:
        delta = softplus(delta)
    h = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    ys = []
    for t in range(x.shape[1]):
        d_t = delta[:, t, :, None]
        h = torch.exp(d_t * A) * h \
            + (d_t * x[:, t, :, None]) * B[:, t, None, :]
        ys.append(torch.einsum("ben,bn->be", h, C[:, t]))
    y = torch.stack(ys, dim=1) + D * x
    if z is not None:
        y = y * F.silu(z)
    return y


def selective_scan_bwd_plain(x, delta, A, B, C, D, z, delta_bias, g,
                             delta_softplus=False):
    """The reverse-time recurrence of K4 (``_bwd_kernel`` in the JAX
    package) as a plain f32 loop: pass 1 recomputes h_t, pass 2 walks t
    from L-1 down to 0 carrying dh, with
    dh_t = C_t ds_t + exp(d_{t+1} A) dh_{t+1}."""
    raw = delta if delta_bias is None else delta + delta_bias
    d = softplus(raw) if delta_softplus else raw
    L = x.shape[1]
    hs = []
    h = x.new_zeros(x.shape[0], x.shape[2], A.shape[1])
    for t in range(L):
        h = torch.exp(d[:, t, :, None] * A) * h \
            + (d[:, t, :, None] * x[:, t, :, None]) * B[:, t, None, :]
        hs.append(h)
    dx, ddelta = torch.empty_like(x), torch.empty_like(x)
    dz = None if z is None else torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(hs[0])
    dD = torch.zeros_like(x[:, 0])
    dh = torch.zeros_like(hs[0])
    for t in reversed(range(L)):
        h_t = hs[t]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(h_t)
        x_t, g_t, d_t = x[:, t], g[:, t], d[:, t]
        delta_a = torch.exp(d_t[..., None] * A)
        if z is None:
            ds = g_t
        else:
            s_t = torch.einsum("ben,bn->be", h_t, C[:, t]) + D * x_t
            z_t = z[:, t]
            sig = torch.sigmoid(z_t)
            ds = g_t * z_t * sig
            dz[:, t] = g_t * s_t * (sig * (1.0 + z_t * (1.0 - sig)))
        dh = dh + C[:, t, None, :] * ds[..., None]
        dh_b = (dh * B[:, t, None, :]).sum(-1)
        dd = dh_b * x_t + (dh * h_prev * A * delta_a).sum(-1)
        dx[:, t] = dh_b * d_t + D * ds
        if delta_softplus:
            dd = dd * torch.sigmoid(raw[:, t])
        ddelta[:, t] = dd
        dB[:, t] = (dh * (d_t * x_t)[..., None]).sum(1)
        dC[:, t] = (h_t * ds[..., None]).sum(1)
        dA = dA + dh * h_prev * d_t[..., None] * delta_a
        dD = dD + ds * x_t
        dh = dh * delta_a
    dbias = None if delta_bias is None else ddelta.sum((0, 1))
    return dx, ddelta, dA.sum(0), dB, dC, dD.sum(0), dz, dbias


def _check(name, t, shape, device):
    if t is None:
        return
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype} != torch.float32")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, x is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_inputs(x, delta, A, B, C, D, z, delta_bias):
    """Validate the scan's inputs for a kernel; returns (B, L, ED, N)."""
    if not x.is_cuda:
        raise ValueError("the scan kernels take CUDA tensors")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x must be (B, L, ED) and A (ED, N)")
    bsz, L, ED = x.shape
    N = A.shape[1]
    if N not in _STATE_SIZES:
        raise ValueError(f"state size N={N} not in {_STATE_SIZES}")
    if 2 * L * N * 4 > _MAX_SMEM:
        raise ValueError(f"L={L} too long: B and C do not fit shared memory")
    _check("x", x, (bsz, L, ED), x.device)
    _check("delta", delta, (bsz, L, ED), x.device)
    _check("A", A, (ED, N), x.device)
    _check("B", B, (bsz, L, N), x.device)
    _check("C", C, (bsz, L, N), x.device)
    _check("D", D, (ED,), x.device)
    _check("z", z, (bsz, L, ED), x.device)
    _check("delta_bias", delta_bias, (ED,), x.device)
    return bsz, L, ED, N


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_cuda(x, delta, A, B, C, D, z=None, delta_bias=None,
                        delta_softplus=False):
    """Launch K2 on contiguous f32 CUDA tensors; raises on anything else."""
    from gfe_mamba_torch.ops.cuda.build import library

    global launches
    bsz, L, ED, N = _check_inputs(x, delta, A, B, C, D, z, delta_bias)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = library("selective_scan").gfe_selective_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), _ptr(z), _ptr(delta_bias),
                out.data_ptr(), bsz, L, ED, N, int(bool(delta_softplus)),
                stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel failed: CUDA error {rc}")
    launches += 1
    return out


def selective_scan_bwd_cuda(x, delta, A, B, C, D, z, delta_bias, g,
                            delta_softplus=False):
    """Launch K4 on contiguous f32 CUDA tensors; raises on anything else.

    The kernel writes dx, ddelta and dz whole, and per-(batch, channel)
    partials of dA, dD and ddelta_bias plus per-(batch, warp) partials of
    dB and dC; the sums over batch and warps run here, in a fixed order."""
    from gfe_mamba_torch.ops.cuda.build import library

    global bwd_launches
    bsz, L, ED, N = _check_inputs(x, delta, A, B, C, D, z, delta_bias)
    _check("g", g, (bsz, L, ED), x.device)
    if x.numel() == 0:
        raise ValueError("selective_scan_bwd_cuda: empty input")
    dx, ddelta = torch.empty_like(x), torch.empty_like(x)
    dz = None if z is None else torch.empty_like(x)
    nwarps = (ED + _NTHREADS - 1) // _NTHREADS * (_NTHREADS // 32)
    f32 = dict(dtype=torch.float32, device=x.device)
    h_buf = torch.empty(bsz, L, N, ED, **f32)
    da_part = torch.empty(bsz, N, ED, **f32)
    daux = torch.empty(bsz, 2, ED, **f32)
    db_part = torch.empty(bsz, nwarps, L, N, **f32)
    dc_part = torch.empty(bsz, nwarps, L, N, **f32)
    fn = library("selective_scan_bwd").gfe_selective_scan_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), _ptr(z), _ptr(delta_bias),
                g.data_ptr(), h_buf.data_ptr(), dx.data_ptr(),
                ddelta.data_ptr(), _ptr(dz), da_part.data_ptr(),
                daux.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
                bsz, L, ED, N, int(bool(delta_softplus)), stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd kernel failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    dbias = None if delta_bias is None else daux[:, 1].sum(0)
    return (dx, ddelta, da_part.sum(0).t().contiguous(), db_part.sum(1),
            dc_part.sum(1), daux[:, 0].sum(0), dz, dbias)
