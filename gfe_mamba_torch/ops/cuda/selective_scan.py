"""K2 and K4: the selective-scan forward kernel
(``csrc/selective_scan.cu``) and its backward (``csrc/selective_scan_bwd.cu``),
each with its plain PyTorch version.

All follow the mamba_ssm contract: x, delta, z ``(B, L, ED)``; A
``(ED, N)``; B, C ``(B, L, N)``; D, delta_bias ``(ED,)``.  The forward
returns y ``(B, L, ED)``, computed with f32 state::

    d = softplus(delta + delta_bias)            (each step optional)
    h = exp(d * A) * h + (d * x) * B_t;  y = C_t . h + D * x
    y = y * silu(z)                              (optional)

The backward takes the cotangent g of y and returns
``(dx, ddelta, dA, dB, dC, dD, dz, ddelta_bias)``, dz None without a gate
and ddelta_bias None without a bias.  ``*_cuda`` launch the kernels on
CUDA tensors, each operand f32 or bf16 with any strides (the packed
``ScanArgs`` carry each one's pointer, strides and dtype); ``*_plain``
are the sequential f32 reference loops over L.
"""

from __future__ import annotations

import ctypes
import struct

import torch
import torch.nn.functional as F

# kernel launches since the counters were last set to 0: K2, K4; the K2
# launches that took the long kernel (v4); and the chunks K2's launches
# walked (``chunks / launches`` per launch)
launches = 0
long_launches = 0
bwd_launches = 0
chunks = 0

# K2 stages a sequence of at most SCAN_WHOLE steps whole, in its short
# kernel (one chunk, 4 channels a block); past it the long kernel (v4)
# walks chunks of ``long_chunk(N)`` steps in blocks of ``long_slab(N)``
# channels of one batch row
SCAN_WHOLE = 64
# v4's states per walking thread and a chunk's steps per walker of a
# channel: csrc/selective_scan.cu's LONG_S and LONG_K.  At (1, 15024,
# 8192, 16) on a Mamba layer's bf16 views an H100 took 1.57 ms with chunks
# of 64 steps in slabs of 64 channels, 1.62 with 32 steps, 1.60 in slabs
# of 32 (v3: 6.35)
LONG_STATES = 4
LONG_ITEMS = 16

_STATE_SIZES = (4, 8, 16, 32)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def long_chunk(N: int) -> int:
    """Steps of v4's chunk at state size N: LONG_ITEMS for each of the
    N / LONG_STATES walkers of a channel."""
    return LONG_ITEMS * N // LONG_STATES


def long_slab(N: int) -> int:
    """v4's channels per block at state size N: 64, whose blocks share
    each chunk's B and C over the most channels, or 32 at N = 32, whose
    slab of 64 would not fit a block."""
    return 64 if N <= 16 else 32


def scan_plan(L: int, N: int) -> tuple[int, int]:
    """(slab, chunk) of K2's launch: ``(0, L)``, the short kernel, up to
    SCAN_WHOLE steps; past it v4's slab and chunk."""
    if L <= SCAN_WHOLE:
        return 0, L
    return long_slab(N), long_chunk(N)


def offsets_fit(t, steps: int, width: int) -> bool:
    """Whether v4's 32-bit offsets inside a chunk, ``steps`` steps of
    ``width`` channels (or states), reach t's elements: always for a
    dense (B, L, ED) tensor below 2^31 elements per batch row."""
    if t is None:
        return True
    _, _, st, se = operand_meta(t)
    return (steps - 1) * st + (width - 1) * se < 2 ** 31


def softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(v)) without torch's threshold shortcut
    (``jax.nn.softplus``)."""
    return torch.clamp(v, min=0.0) + torch.log1p(torch.exp(-v.abs()))


def selective_scan_plain(x, delta, A, B, C, D, z=None, delta_bias=None,
                         delta_softplus=False, return_state=False):
    """Sequential f32 loop over L (the ``mode='sequential'`` recurrence of
    the JAX package); with ``return_state``, ``(y, last h (B, ED, N))``."""
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
    y = (torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)) + D * x
    if z is not None:
        y = y * F.silu(z)
    return (y, h) if return_state else y


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


# ``Operand`` of csrc/scan.cuh: data pointer; batch, time and
# last-dimension strides in elements; bf16 flag; padding.  An absent
# operand is all zeros (a null pointer).
OPERAND = struct.Struct("@qqqqii")
_ABSENT = bytes(OPERAND.size)
# ``ScanArgs`` of csrc/scan.cuh is 11 operands (x, delta, z, B, C, D, bias,
# g, y, ddelta, dz) then this tail: A, part, grads; batch, L, ED, N,
# softplus, slab (K2's kernel; 0 for K4).  The arguments go to the C entry
# points as these bytes: cheaper on the host than a ctypes.Structure
# filled field by field, and the training step is host-bound.
_TAIL = struct.Struct("@qqqiiiiii")
ARGS_SIZE = 11 * OPERAND.size + _TAIL.size


def operand_meta(t) -> tuple[int, int, int, int]:
    """(bf16, batch stride, time stride, last-dimension stride) with which
    the kernels read ``t``: its own strides, a vector's batch and time
    strides 0."""
    if t is None:
        return 0, 0, 0, 0
    bf16 = int(t.dtype == torch.bfloat16)
    if t.dim() == 3:
        return (bf16, *t.stride())
    return bf16, 0, 0, t.stride(0)


def kernel_operand(t):
    """``t`` as the kernels take it: as it is (a view, strided, bf16) when
    it is f32 or bf16, else cast to f32.  The caller makes this choice;
    the wrappers raise on anything else."""
    if t is None or t.dtype in KERNEL_DTYPES:
        return t
    return t.float()


def _operand(t) -> bytes:
    if t is None:
        return _ABSENT
    bf16, sb, st, se = operand_meta(t)
    return OPERAND.pack(t.data_ptr(), sb, st, se, bf16, 0)


def _args(operands, A, part, grads, bsz, L, ED, N, softplus,
          slab=0) -> bytes:
    return b"".join([*map(_operand, operands), _TAIL.pack(
        A.data_ptr(), part, grads, bsz, L, ED, N, int(bool(softplus)),
        slab)])


def _check(name, t, shape, device, dtypes=KERNEL_DTYPES):
    if t is None:
        return
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, x is on {device}")


def _check_inputs(x, delta, A, B, C, D, z, delta_bias):
    """Validate the scan's inputs; returns (B, L, ED, N).  A sequence too
    long for a block's shared memory is refused by K4's launch (K2 walks
    any L in chunks).

    x, delta, z, B, C, D and delta_bias may each be f32 or bf16, with any
    strides; A is f32 and contiguous."""
    if not x.is_cuda:
        raise ValueError("the scan kernels take CUDA tensors")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x must be (B, L, ED) and A (ED, N)")
    bsz, L, ED = x.shape
    N = A.shape[1]
    if N not in _STATE_SIZES:
        raise ValueError(f"state size N={N} not in {_STATE_SIZES}")
    _check("x", x, (bsz, L, ED), x.device)
    _check("delta", delta, (bsz, L, ED), x.device)
    _check("A", A, (ED, N), x.device, (torch.float32,))
    if not A.is_contiguous():
        raise ValueError("A: must be contiguous")
    _check("B", B, (bsz, L, N), x.device)
    _check("C", C, (bsz, L, N), x.device)
    _check("D", D, (ED,), x.device)
    _check("z", z, (bsz, L, ED), x.device)
    _check("delta_bias", delta_bias, (ED,), x.device)
    return bsz, L, ED, N


_entry: dict[str, object] = {}


def _function(source, name, restype, argtypes):
    """``name`` of ``csrc/<source>.cu``'s library, typed, looked up once."""
    fn = _entry.get(name)
    if fn is None:
        from gfe_mamba_torch.ops.cuda.build import library

        fn = getattr(library(source), name)
        fn.restype = restype
        fn.argtypes = argtypes
        _entry[name] = fn
    return fn


def _launch(name, args: bytes, device) -> int:
    """Call ``gfe_<name>`` of ``csrc/<name>.cu`` on ``device``'s current
    stream with the packed ``ScanArgs``; returns its CUDA error code."""
    fn = _function(name, f"gfe_{name}", ctypes.c_int,
                   [ctypes.c_char_p, ctypes.c_void_p])
    if device.index == torch.cuda.current_device():
        return fn(args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(args, torch.cuda.current_stream().cuda_stream)


def selective_scan_cuda(x, delta, A, B, C, D, z=None, delta_bias=None,
                        delta_softplus=False, return_state=False):
    """Launch K2 on CUDA tensors; raises on anything it cannot take.

    x, delta, z, B, C, D and delta_bias may be f32 or bf16, with any
    strides; y comes back contiguous in x's dtype, and with
    ``return_state`` beside the last state ``(B, ED, N)`` in f32.  Any L:
    past ``SCAN_WHOLE`` steps the long kernel (v4) walks it in chunks
    (``scan_plan``); an operand whose strides would overflow v4's 32-bit
    offsets inside a chunk goes in as a contiguous copy."""
    global launches, long_launches, chunks
    bsz, L, ED, N = _check_inputs(x, delta, A, B, C, D, z, delta_bias)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty(bsz, ED, N, dtype=torch.float32, device=x.device) \
        if return_state else None
    if out.numel() == 0:
        return (out, state.zero_()) if return_state else out
    slab, chunk = scan_plan(L, N)
    if slab:
        if not offsets_fit(out, chunk, slab):
            raise ValueError(f"y: a chunk of {chunk} steps of {ED} channels "
                             f"is past 32-bit offsets")
        x, delta, z = (t if offsets_fit(t, chunk, slab) else t.contiguous()
                       for t in (x, delta, z))
        B, C = (t if offsets_fit(t, chunk, N) else t.contiguous()
                for t in (B, C))
    args = _args((x, delta, z, B, C, D, delta_bias, None, out, None, None),
                 A, 0 if state is None else state.data_ptr(), 0, bsz, L, ED,
                 N, delta_softplus, slab)
    rc = _launch("selective_scan", args, x.device)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel failed: CUDA error {rc}")
    launches += 1
    long_launches += bool(slab)
    chunks += -(-L // chunk)
    return (out, state) if return_state else out


def occupancy(L: int, N: int) -> int:
    """Resident blocks per SM of the K2 kernel that a launch of L steps at
    state size N on a Mamba layer's bf16 views (channel-major x, a gate,
    softplus) takes on the current card (CUDA's occupancy calculator)."""
    view = OPERAND.pack(1, 0, 1, L, 1, 0)     # bf16, channel-major, present
    args = b"".join([view] * 6 + [_ABSENT] + [view] * 4) + _TAIL.pack(
        0, 0, 0, 1, L, 1, N, 1, scan_plan(L, N)[0])
    blocks = ctypes.c_int(0)
    rc = _function("selective_scan", "gfe_selective_scan_occupancy",
                   ctypes.c_int, [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int)])(
        args, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"selective_scan occupancy: CUDA error {rc}")
    return blocks.value


def selective_scan_bwd_cuda(x, delta, A, B, C, D, z, delta_bias, g,
                            delta_softplus=False):
    """Launch K4 on CUDA tensors; raises on anything it cannot take.

    x, delta, z, g, B, C, D and delta_bias may be f32 or bf16, with any
    strides.  dx, ddelta and dz come back in x's, delta's and z's dtype;
    dA, dB, dC, dD and ddelta_bias in f32, summed over blocks and batch
    in a fixed order by the kernel's second launch."""
    global bwd_launches
    bsz, L, ED, N = _check_inputs(x, delta, A, B, C, D, z, delta_bias)
    _check("g", g, (bsz, L, ED), x.device)
    if x.numel() == 0:
        raise ValueError("selective_scan_bwd_cuda: empty input")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddelta = torch.empty(x.shape, dtype=delta.dtype, device=x.device)
    dz = None if z is None else torch.empty(x.shape, dtype=z.dtype,
                                            device=x.device)
    # the kernel's scratch (its size from the library) and the f32
    # gradients dB, dC, dA, dD, dbias: one allocation, gradients first
    n_part = _function("selective_scan_bwd", "gfe_selective_scan_bwd_scratch",
                       ctypes.c_longlong, [ctypes.c_int] * 4)(bsz, L, ED, N)
    n_grads = 2 * bsz * L * N + ED * N + 2 * ED
    buf = torch.empty(n_grads + n_part, dtype=torch.float32,
                      device=x.device)
    args = _args((x, delta, z, B, C, D, delta_bias, g, dx, ddelta, dz), A,
                 buf.data_ptr() + 4 * n_grads, buf.data_ptr(), bsz, L, ED,
                 N, delta_softplus)
    rc = _launch("selective_scan_bwd", args, x.device)
    if rc != 0:
        raise RuntimeError(f"selective_scan_bwd kernel failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    bln = bsz * L * N
    dB, dC, dA, dD, dbias, _ = torch.split(
        buf, [bln, bln, ED * N, ED, ED, n_part])
    return (dx, ddelta, dA.view(ED, N), dB.view(bsz, L, N),
            dC.view(bsz, L, N), dD, dz,
            None if delta_bias is None else dbias)
