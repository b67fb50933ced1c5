"""K1 and K3: the fused GN-apply + 3x3x3 conv kernel (``csrc/conv3d.cu``)
and the conv's weight-gradient kernel (``csrc/conv3d_dw.cu``), each with
its plain PyTorch version.

K1 computes, channels-last, SAME padding, stride 1::

    post_act(act(conv3d(x * pre_scale + pre_shift, w) + bias) + residual)

with x ``(B, X, Y, Z, C)``, w ``(3, 3, 3, C, F)`` (the flax layout),
bias ``(F,)``, pre_scale/pre_shift ``(B, C)`` in f32 (the folded
GroupNorm) and residual ``(B, X, Y, Z, F)``.  The affine applies to real
voxels only; the zero halo stays zero.  K3 computes the weight gradient
of that conv, ``dw[i,j,k,c,f] = sum zhat[b,x+i-1,y+j-1,z+k-1,c] *
g1[b,x,y,z,f]`` in f32, with ``zhat = x * pre_scale + pre_shift`` formed
in x's dtype and zero outside the volume.  ``*_cuda`` launch the kernels
on CUDA tensors; ``*_plain`` are the references the CPU path, the tests
and the on-card checks use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

ACT_CODES = {"none": 0, "relu": 1, "elu": 2, "leaky01": 3, "leaky001": 4}
# K1's bf16 launch (csrc/conv3d.cu): the output bricks (x, y, z) of one
# block that the kernel compiles, one wgmma's N being an x slice of the
# brick (y x z voxels); the output channels of one block (wgmma's M); the
# input channels of one staged chunk; the stages of the TMA ring; the
# H100's SMs, a wave of blocks at one per SM; and the shared memory a
# block may take on the H100.
CONV_BRICKS = ((4, 16, 8), (8, 8, 8))
_CONV_BN = 64
_CONV_CK = 16
_CONV_STAGES = 2
_SMS = 132
SMEM_LIMIT = 232448
# K1's f32 launch (csrc/conv3d.cu, CUDA cores): the brick (x, y, z) of a
# block by its tile of output channels, which the kernel must have
# compiled (32 where F <= 32, else 64); the input channels of one staged
# chunk; and the stages of the cp.async ring.
CONV_F32_BRICKS = {32: (8, 8, 8), 64: (4, 8, 8)}
_CONV_F32_CK = 8
_CONV_F32_STAGES = 2
# K3's launch shapes (csrc/conv3d_dw.cu).  Both variants: the (c, f) tile;
# the tap groups, as the dx of each (the blocks of group g serve the 9
# (dy, dz) taps of dx DW_GROUP_DX[g] from one staged slab; the kernels
# read this table).  bf16 (tensor cores): the voxel brick and the waves of
# one block per SM the brick split aims for.  f32 (CUDA cores): its voxel
# brick, the stages of its cp.async ring, and the most waves of one block
# per SM its split weighs.
_DW_TILE = 64
DW_BRICK = (4, 4, 16)
DW_GROUP_DX = (0, 1, 2)
_DW_WAVES = 4
DW_F32_BRICK = (1, 8, 16)
_DW_F32_STAGES = 2
_DW_F32_MAX_WAVES = 8

# kernel launches since the counters were last set to 0: K1 in all, and
# by variant (bf16 on tensor cores, f32 on CUDA cores); K3 likewise
launches = 0
mma_launches = 0
fma_launches = 0
dw_launches = 0
dw_mma_launches = 0
dw_fma_launches = 0


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation set of the fused conv (``_apply_act`` in the JAX
    package): none, relu, elu, leaky 0.1, leaky 0.01."""
    if act == "none":
        return y
    if act == "relu":
        return torch.clamp(y, min=0.0)
    if act == "elu":
        return torch.where(y > 0, y, torch.exp(torch.clamp(y, max=0.0)) - 1.0)
    if act == "leaky01":
        return torch.where(y > 0, y, 0.1 * y)
    if act == "leaky001":
        return torch.where(y > 0, y, 0.01 * y)
    raise ValueError(f"unknown activation {act!r}")


def conv3x3x3_plain(x, w, bias=None, pre_scale=None, pre_shift=None,
                    residual=None, act="none", post_act="none"):
    """Plain PyTorch version: affine in x's dtype, ``F.conv3d`` on the
    channels-first view, then the epilogue in f32, rounded once."""
    x = affine_in_dtype(x, pre_scale, pre_shift)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=1).permute(0, 2, 3, 4, 1).float()
    if bias is not None:
        y = y + bias.float()
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual.float()
    return apply_act(y, post_act).to(x.dtype)


def affine_in_dtype(x, pre_scale=None, pre_shift=None):
    """``x * pre_scale + pre_shift`` per (batch, channel), each step
    rounded to x's dtype as the JAX package does."""
    if pre_scale is not None:
        x = x * pre_scale.to(x.dtype)[:, None, None, None, :]
    if pre_shift is not None:
        x = x + pre_shift.to(x.dtype)[:, None, None, None, :]
    return x


def conv3x3x3_dw_plain(x, g1, pre_scale=None, pre_shift=None):
    """Plain K3: the 27-tap weight gradient as f32 einsums over shifted
    slices of the zero-padded ``zhat`` (``_bwd_core`` in the JAX
    package).  Returns dw ``(3, 3, 3, C, F)`` in f32."""
    B, X, Y, Z, C = x.shape
    zp = F.pad(affine_in_dtype(x, pre_scale, pre_shift),
               (0, 0, 1, 1, 1, 1, 1, 1)).float()
    g = g1.float()
    taps = [torch.einsum("bxyzc,bxyzf->cf",
                         zp[:, i:i + X, j:j + Y, k:k + Z], g)
            for i in range(3) for j in range(3) for k in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, C, g1.shape[-1])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, shape, dtype, device):
    if t is None:
        return
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, x is on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _affine_for_kernel(dtype, pre_scale, pre_shift):
    """The kernels round the affine to x's dtype as JAX does: in bf16 they
    take (a, s) already rounded to bf16, as f32."""
    if dtype != torch.bfloat16:
        return pre_scale, pre_shift
    return tuple(None if t is None else t.to(torch.bfloat16).float()
                 for t in (pre_scale, pre_shift))


class ConvPlan(NamedTuple):
    """The bf16 K1 launch.  ``blocks`` = B x ``tiles``: the bricks of the
    volume along x, y and z and the tiles of ``tile`` output channels,
    decoded by the kernel with the channel tile fastest, then z, y, x and
    the batch.  Each of a block's two warpgroups takes half the brick's x
    slices, one wgmma of N = ``mma_n`` voxels (y x z) per slice and tap.
    The boxes are the three TMA loads of a chunk (innermost dimension
    first): w's ``(F, C, taps)`` over its (27, C, F) view, 128-byte
    swizzled, and x's halo ``(channels, z, y, x, batch)`` twice, one plane
    of 8 channels each, unswizzled; ``strides`` are their tensors' byte
    strides past the innermost dimension.  The halo's wgmma descriptor
    steps ``desc_strides`` bytes: to the second plane (along K), to the
    next column (y + 1: along N, and a tap's dy), to the next row (z + 1:
    a tap's dz) and to the next x slice (a tap's dx)."""
    brick: tuple[int, int, int]
    tile: int
    mma_n: int
    tiles: tuple[int, int, int, int]
    blocks: int
    stages: int
    smem_bytes: int
    halo_box: tuple[int, ...]
    weight_box: tuple[int, ...]
    halo_strides: tuple[int, ...]
    weight_strides: tuple[int, ...]
    plane_bytes: int
    desc_strides: tuple[int, ...]


def _kb_up(n: int) -> int:
    return -(-n // 1024) * 1024


def mma_plan(brick, B, X, Y, Z, C, F) -> ConvPlan:
    """K1's bf16 launch over one of ``CONV_BRICKS``: a ring stage holds a
    16-channel chunk's weights (432 rows of 128 bytes) then its halo as
    two planes of 16-byte rows (8 channels each; a plane a multiple of
    128 bytes), each part from a multiple of 1,024 bytes; the f32 output
    tile (rows of 68 floats) reuses the ring; 1,024 bytes more align the
    ring."""
    bx, by, bz = brick
    hx, hy, hz = bx + 2, by + 2, bz + 2
    tiles = (-(-X // bx), -(-Y // by), -(-Z // bz), -(-F // _CONV_BN))
    plane = -(-16 * hx * hy * hz // 128) * 128
    stage = 2 * _CONV_BN * _CONV_CK * 27 + _kb_up(2 * plane)
    tile = bx * by * bz * (_CONV_BN + 4) * 4
    row = 2 * C
    return ConvPlan(
        brick=tuple(brick), tile=_CONV_BN, mma_n=by * bz, tiles=tiles,
        blocks=B * tiles[0] * tiles[1] * tiles[2] * tiles[3],
        stages=_CONV_STAGES,
        smem_bytes=max(_CONV_STAGES * stage, tile) + 1024,
        halo_box=(_CONV_CK // 2, hz, hy, hx, 1),
        weight_box=(_CONV_BN, _CONV_CK, 27),
        halo_strides=(row, row * Z, row * Z * Y, row * Z * Y * X),
        weight_strides=(2 * F, 2 * F * C), plane_bytes=plane,
        desc_strides=(plane, 16 * hz, 16, 16 * hy * hz))


def conv_plan(B, X, Y, Z, C, F) -> ConvPlan:
    """K1's bf16 launch for x ``(B, X, Y, Z, C)`` and F output channels:
    one block per (brick, 64-channel tile), over the brick of
    ``CONV_BRICKS`` that pads the volume least, the widest N among those,
    as long as its blocks fill a wave of the card's SMs (else the brick
    with the most blocks)."""
    plans = [mma_plan(brick, B, X, Y, Z, C, F) for brick in CONV_BRICKS]
    full = [p for p in plans if p.blocks >= _SMS] \
        or [max(plans, key=lambda p: p.blocks)]
    return min(full, key=lambda p: (p.blocks * p.brick[0] * p.brick[1]
                                    * p.brick[2], -p.mma_n))


class ConvF32Plan(NamedTuple):
    """The f32 K1 launch.  ``blocks`` = B x ``tiles``: the bricks of the
    volume along x, y and z and the tiles of ``tile`` output channels,
    decoded by the kernel as the bf16 launch's are (channel tile fastest,
    then z, y, x and the batch)."""
    brick: tuple[int, int, int]
    tile: int
    tiles: tuple[int, int, int, int]
    blocks: int
    stages: int
    smem_bytes: int


def conv_f32_plan(B, X, Y, Z, C, F) -> ConvF32Plan:
    """K1's f32 launch for x ``(B, X, Y, Z, C)`` and F output channels:
    one block per (brick, channel tile), the tile 32 wide where F <= 32
    (no FMA on a channel beyond F) and 64 wide otherwise.  A ring stage
    holds an 8-channel chunk's weights (27 x 8 rows of ``tile`` floats)
    and its halo (rows of 8 floats); the f32 output tile (rows of
    ``tile`` + 4 floats) reuses the ring."""
    tile = 32 if F <= 32 else 64
    bx, by, bz = CONV_F32_BRICKS[tile]
    tiles = (-(-X // bx), -(-Y // by), -(-Z // bz), -(-F // tile))
    halo = (bx + 2) * (by + 2) * (bz + 2)
    stage = 4 * _CONV_F32_CK * (27 * tile + halo)
    smem = max(_CONV_F32_STAGES * stage, bx * by * bz * (tile + 4) * 4)
    return ConvF32Plan(
        brick=(bx, by, bz), tile=tile, tiles=tiles,
        blocks=B * tiles[0] * tiles[1] * tiles[2] * tiles[3],
        stages=_CONV_F32_STAGES, smem_bytes=smem)


def conv3x3x3_cuda(x, w, bias=None, pre_scale=None, pre_shift=None,
                   residual=None, act="none", post_act="none"):
    """Launch K1.  Takes f32 or bf16 CUDA tensors with C and F multiples
    of 8; raises on anything else.  bf16 takes the tensor-core variant
    with ``conv_plan``'s launch, f32 the CUDA-core one with
    ``conv_f32_plan``'s; neither falls back to the other."""
    from gfe_mamba_torch.ops.cuda.build import library

    global launches, mma_launches, fma_launches
    if not x.is_cuda:
        raise ValueError("conv3x3x3_cuda takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3x3_cuda: unsupported dtype {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, X, Y, Z, C), got {tuple(x.shape)}")
    B, X, Y, Z, C = x.shape
    if w.dim() != 5:
        raise ValueError(f"w must be (3, 3, 3, C, F), got {tuple(w.shape)}")
    Fo = w.shape[-1]
    if C % 8 or Fo % 8:
        raise ValueError(f"C={C} and F={Fo} must be multiples of 8")
    if act not in ACT_CODES or post_act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r} / {post_act!r}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check("w", w, (3, 3, 3, C, Fo), x.dtype, x.device)
    _check("bias", bias, (Fo,), x.dtype, x.device)
    _check("pre_scale", pre_scale, (B, C), torch.float32, x.device)
    _check("pre_shift", pre_shift, (B, C), torch.float32, x.device)
    _check("residual", residual, (B, X, Y, Z, Fo), x.dtype, x.device)
    out = torch.empty((B, X, Y, Z, Fo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    pre_scale, pre_shift = _affine_for_kernel(x.dtype, pre_scale, pre_shift)
    lib = library("conv3d")
    mma = x.dtype == torch.bfloat16
    if mma:
        plan = conv_plan(B, X, Y, Z, C, Fo)
        plan_args = (*plan.brick, *plan.tiles, plan.stages, plan.smem_bytes)
        fn = lib.gfe_conv3x3x3_bf16
    else:
        plan = conv_f32_plan(B, X, Y, Z, C, Fo)
        plan_args = (*plan.brick, plan.tile, *plan.tiles, plan.stages,
                     plan.smem_bytes)
        fn = lib.gfe_conv3x3x3_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * (8 + len(plan_args)) + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(pre_scale),
                _ptr(pre_shift), _ptr(residual), out.data_ptr(),
                B, X, Y, Z, C, Fo, ACT_CODES[act], ACT_CODES[post_act],
                *plan_args, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3x3 kernel failed: CUDA error {rc}")
    launches += 1
    if mma:
        mma_launches += 1
    else:
        fma_launches += 1
    return out


class DwPlan(NamedTuple):
    """The bf16 K3 launch: split s takes bricks ``[s * per, min(bricks,
    (s + 1) * per))`` of the volume's ``DW_BRICK`` bricks."""
    per: int
    splits: int


def _bricks(B, X, Y, Z, brick) -> int:
    return B * -(-X // brick[0]) * -(-Y // brick[1]) * -(-Z // brick[2])


def _dw_tiles(C, F) -> int:
    """The blocks of one split: tap groups x c tiles x f tiles."""
    return len(DW_GROUP_DX) * -(-C // _DW_TILE) * -(-F // _DW_TILE)


def dw_plan(B, X, Y, Z, C, F, sms) -> DwPlan:
    """Split the bricks so that the blocks fill ``_DW_WAVES`` waves of one
    block per SM on a card of ``sms`` SMs (at least; fewer where the
    volume has fewer bricks)."""
    bricks = _bricks(B, X, Y, Z, DW_BRICK)
    want = -(-_DW_WAVES * sms // _dw_tiles(C, F))
    per = -(-bricks // max(1, min(want, bricks)))
    return DwPlan(per, -(-bricks // per))


class DwFmaPlan(NamedTuple):
    """The f32 K3 launch: split s takes bricks ``[s * per, min(bricks,
    (s + 1) * per))`` of the volume's ``brick`` bricks; a block stages a
    brick's x slab and g1 rows into each of ``stages`` stages."""
    brick: tuple[int, int, int]
    per: int
    splits: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def dw_fma_plan(B, X, Y, Z, C, F, sms) -> DwFmaPlan:
    """Split the bricks for the least makespan on a card of ``sms`` SMs
    holding one block each: waves x (bricks per block + a quarter brick,
    the first load that no compute hides), over splits that fill at most
    ``_DW_F32_MAX_WAVES`` waves; the fewest splits among equals.  Blocks
    of equal work in whole waves waste nothing, where a fixed wave count
    can leave its last wave nearly empty."""
    bx, by, bz = DW_F32_BRICK
    bricks = _bricks(B, X, Y, Z, DW_F32_BRICK)
    tiles = _dw_tiles(C, F)
    best = None
    for want in range(1, min(bricks, -(-_DW_F32_MAX_WAVES * sms // tiles))
                      + 1):
        per = -(-bricks // want)
        splits = -(-bricks // per)
        cost = -(-splits * tiles // sms) * (4 * per + 1)
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    rows = bx * (by + 2) * (bz + 2) + bx * by * bz
    return DwFmaPlan(DW_F32_BRICK, best[1], best[2], _DW_F32_STAGES,
                     _DW_F32_STAGES * rows * _DW_TILE * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv3x3x3_dw_cuda(x, g1, pre_scale=None, pre_shift=None):
    """Launch K3: f32 or bf16 CUDA tensors x ``(B, X, Y, Z, C)`` and g1
    ``(B, X, Y, Z, F)`` of one dtype, C and F multiples of 8, pre_scale
    and pre_shift ``(B, C)`` f32 or None; returns dw ``(3, 3, 3, C, F)``
    f32.  Raises on anything else.

    bf16 takes the tensor-core variant (``dw_plan``), f32 the CUDA-core
    one (``dw_fma_plan``); neither falls back to the other.  Each splits
    the voxels over blocks and writes one f32 partial per split; the sum
    over splits runs here, in a fixed order, so the result is
    deterministic."""
    from gfe_mamba_torch.ops.cuda.build import library

    global dw_launches, dw_mma_launches, dw_fma_launches
    if not x.is_cuda:
        raise ValueError("conv3x3x3_dw_cuda takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3x3_dw_cuda: unsupported dtype {x.dtype}")
    if x.dim() != 5 or g1.dim() != 5:
        raise ValueError("x and g1 must be (B, X, Y, Z, C) and (B, X, Y, Z, F)")
    B, X, Y, Z, C = x.shape
    Fo = g1.shape[-1]
    if C % 8 or Fo % 8:
        raise ValueError(f"C={C} and F={Fo} must be multiples of 8")
    voxels = B * X * Y * Z
    if voxels == 0 or voxels >= 2 ** 31:
        raise ValueError(f"conv3x3x3_dw_cuda: {voxels} voxels out of range")
    _check("x", x, x.shape, x.dtype, x.device)
    _check("g1", g1, (B, X, Y, Z, Fo), x.dtype, x.device)
    _check("pre_scale", pre_scale, (B, C), torch.float32, x.device)
    _check("pre_shift", pre_shift, (B, C), torch.float32, x.device)
    pre_scale, pre_shift = _affine_for_kernel(x.dtype, pre_scale, pre_shift)
    lib = library("conv3d_dw")
    mma = x.dtype == torch.bfloat16
    sms = _sm_count(x.device.index)
    # the group table, two bits per group's dx
    groups = (sum(dx << 2 * g for g, dx in enumerate(DW_GROUP_DX)),
              len(DW_GROUP_DX))
    if mma:
        per, splits = dw_plan(B, X, Y, Z, C, Fo, sms)
        plan_args = (per, *groups)
        fn = lib.gfe_conv3x3x3_dw_bf16
    else:
        plan = dw_fma_plan(B, X, Y, Z, C, Fo, sms)
        splits = plan.splits
        plan_args = (*plan.brick, plan.per, *groups, plan.stages,
                     plan.smem_bytes)
        fn = lib.gfe_conv3x3x3_dw_f32
    part = torch.empty(splits, 27, C, Fo, dtype=torch.float32,
                       device=x.device)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * (6 + len(plan_args)) + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g1.data_ptr(), _ptr(pre_scale),
                _ptr(pre_shift), part.data_ptr(), B, X, Y, Z, C, Fo,
                *plan_args, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3x3_dw kernel failed: CUDA error {rc}")
    dw_launches += 1
    if mma:
        dw_mma_launches += 1
    else:
        dw_fma_launches += 1
    return part.sum(0).reshape(3, 3, 3, C, Fo)
