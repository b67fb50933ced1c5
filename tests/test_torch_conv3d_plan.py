"""The launch plans of K1 (``conv_plan`` for the bf16 tensor-core variant,
over ``mma_plan`` for each compiled brick, and ``conv_f32_plan`` for the
f32 CUDA-core one, in ``gfe_mamba_torch/ops/cuda/conv3d.py``), on the CPU:
the blocks, decoded in the kernel's order with the plan's own channel
tile, put every output voxel and channel in exactly one block; a ring
stage and the epilogue tile fit one block's shared memory on an H100
(232,448 bytes); the f32 plan takes its narrow tile where F <= 32; every
TMA box dimension is at most 256 and its innermost extent fits its
swizzle; the tensors' byte strides and the bf16 halo's wgmma descriptor
offsets are multiples of 16, as the TMA and wgmma require; and at the
generator's three levels the bf16 plan fills a wave of the H100's 132
SMs, pads nothing and takes its widest N.
"""

import numpy as np
import pytest

from gfe_mamba_torch.ops.cuda import conv3d as k1

# the generator's three levels at batch 1 (Stage 1, dz) and 4 (serving),
# and ragged volumes: X and Y not multiples of the brick, Z = 24, C != F
SHAPES = [((b, 160, 160, 96), 64, 64) for b in (1, 4)] \
    + [((b, 80, 80, 48), 128, 128) for b in (1, 4)] \
    + [((b, 40, 40, 24), 256, 256) for b in (1, 4)] \
    + [((2, 9, 13, 21), 24, 40), ((1, 5, 7, 24), 24, 40),
       ((3, 11, 6, 24), 128, 64)]


def _decode(plan):
    """Each block's (batch, x, y, z, channel) origin, in the kernel's
    order: channel tile fastest, then z, y, x and the batch."""
    nxt, nyt, nzt, ftiles = plan.tiles
    ids = np.arange(plan.blocks)
    ft, ids = ids % ftiles, ids // ftiles
    zt, ids = ids % nzt, ids // nzt
    yt, ids = ids % nyt, ids // nyt
    xt, b = ids % nxt, ids // nxt
    bx, by, bz = plan.brick
    return b, xt * bx, yt * by, zt * bz, ft * plan.tile


def _plans(shape, C, F):
    """The plan conv_plan chooses, then the plan over every compiled
    brick."""
    return [k1.conv_plan(*shape, C, F)] \
        + [k1.mma_plan(brick, *shape, C, F) for brick in k1.CONV_BRICKS]


def _assert_covers(plan, shape, F):
    B, X, Y, Z = shape
    b, x0, y0, z0, n0 = _decode(plan)
    assert b.min() == 0 and b.max() == B - 1
    # distinct origins, each brick starting inside the volume ...
    origins = np.stack([b, x0, y0, z0, n0], 1)
    assert len(np.unique(origins, axis=0)) == plan.blocks
    assert (x0 < X).all() and (y0 < Y).all() and (z0 < Z).all() \
        and (n0 < F).all()
    # ... and along each axis the bricks' extents tile [0, n) once
    for starts, size, n in ((x0, plan.brick[0], X), (y0, plan.brick[1], Y),
                            (z0, plan.brick[2], Z), (n0, plan.tile, F)):
        cover = np.zeros(n, int)
        for start in np.unique(starts):
            cover[start:start + size] += 1
        assert (cover == 1).all()
    assert plan.blocks == B * np.prod(plan.tiles)


@pytest.mark.parametrize("shape,C,F", SHAPES)
def test_conv_plan_puts_every_output_in_one_block(shape, C, F):
    _assert_covers(k1.conv_plan(*shape, C, F), shape, F)


@pytest.mark.parametrize("brick", k1.CONV_BRICKS)
@pytest.mark.parametrize("shape,C,F", SHAPES)
def test_mma_plan_puts_every_output_in_one_block(shape, C, F, brick):
    """Every brick the kernel compiles, whether or not conv_plan takes it
    for this shape."""
    _assert_covers(k1.mma_plan(brick, *shape, C, F), shape, F)


@pytest.mark.parametrize("shape,C,F", SHAPES)
def test_conv_plan_fits_the_card(shape, C, F):
    for plan in _plans(shape, C, F):
        assert plan.brick in k1.CONV_BRICKS
        assert plan.smem_bytes <= k1.SMEM_LIMIT
        bx, by, bz = plan.brick
        halo = 2 * np.prod(plan.halo_box)
        weights = 2 * np.prod(plan.weight_box)
        # two planes of the chunk's 16 channels, each from 128 bytes
        assert plan.plane_bytes % 128 == 0 and plan.plane_bytes >= halo
        stage = weights + -(-2 * plan.plane_bytes // 1024) * 1024
        assert plan.stages >= 2
        assert plan.stages * stage + 1024 <= plan.smem_bytes
        assert bx * by * bz * (plan.tile + 4) * 4 + 1024 <= plan.smem_bytes
        assert max(plan.halo_box + plan.weight_box) <= 256
        # innermost box extents: 16 bytes (a core matrix row, no
        # swizzle), 128 (the 128-byte swizzle); 16 input channels, one k16
        assert 2 * plan.halo_box[0] == 16 and 2 * plan.weight_box[0] == 128
        assert plan.weight_box[1] == 2 * plan.halo_box[0] == 16
        assert plan.halo_box[1:] == (bz + 2, by + 2, bx + 2, 1)
        # one wgmma: M = the 64-channel tile, N = an x slice of whole
        # 8-voxel core matrices, at most 256; two warpgroups share the
        # slices, 128 accumulators a thread at most
        assert plan.tile == 64 and bz == 8
        assert plan.mma_n == by * bz and plan.mma_n % 8 == 0 \
            and plan.mma_n <= 256
        assert bx % 2 == 0 and bx // 2 * plan.mma_n // 2 <= 128


@pytest.mark.parametrize("shape,C,F", SHAPES)
def test_conv_plan_strides_are_multiples_of_16_bytes(shape, C, F):
    B, X, Y, Z = shape
    for plan in _plans(shape, C, F):
        bx, by, bz = plan.brick
        assert plan.halo_strides[0] == 2 * C
        assert plan.halo_strides[-1] == 2 * C * Z * Y * X
        assert plan.weight_strides == (2 * F, 2 * F * C)
        assert all(s % 16 == 0
                   for s in plan.halo_strides + plan.weight_strides)
        # the halo descriptor's steps: to the second plane, to the next
        # column (y), row (z) and x slice; each below the 14-bit field of
        # 16-byte units
        assert plan.desc_strides == (plan.plane_bytes, 16 * (bz + 2), 16,
                                     16 * (by + 2) * (bz + 2))
        assert all(s % 16 == 0 and 0 < s < 16 * 2 ** 14
                   for s in plan.desc_strides)


@pytest.mark.parametrize("shape,C,F", SHAPES[:6])
def test_conv_plan_pads_nothing_at_the_generator_levels(shape, C, F):
    """The bricks tile every level exactly, Z = 24 included (a 16-deep
    brick would leave the second z brick half empty there)."""
    plan = k1.conv_plan(*shape, C, F)
    voxels = np.prod(shape)
    assert plan.blocks * np.prod(plan.brick) * plan.tile == voxels * F


@pytest.mark.parametrize("shape,C,F", SHAPES[:6])
def test_conv_plan_fills_a_wave_at_the_generator_levels(shape, C, F):
    """At least one block per SM of the H100 at batch 1 and 4, and among
    the bricks that pad nothing the widest N (the most FLOP per byte the
    wgmmas read)."""
    plan = k1.conv_plan(*shape, C, F)
    assert plan.blocks >= 132
    exact = [k1.mma_plan(brick, *shape, C, F) for brick in k1.CONV_BRICKS]
    exact = [p for p in exact if p.blocks * np.prod(p.brick) * p.tile
             == np.prod(shape) * F]
    assert plan.mma_n == max(p.mma_n for p in exact)


# K1's f32 launch (``conv_f32_plan``).  The segmentation UNet3D's 13 K1
# convs (f_maps 64, a 64x128x128 patch, batch 1) as forwards and as input
# gradients (C and F swapped: the 64 -> 32 of the first conv's dz takes
# the narrow tile), the generator's three levels at batch 1 and 4, and
# ragged volumes (X, Y, Z not multiples of either brick, C != F)
UNET3D_CONVS = [((64, 128, 128), 32, 64), ((32, 64, 64), 64, 64),
                ((32, 64, 64), 64, 128), ((16, 32, 32), 128, 128),
                ((16, 32, 32), 128, 256), ((8, 16, 16), 256, 256),
                ((8, 16, 16), 256, 512), ((16, 32, 32), 768, 256),
                ((16, 32, 32), 256, 256), ((32, 64, 64), 384, 128),
                ((32, 64, 64), 128, 128), ((64, 128, 128), 192, 64),
                ((64, 128, 128), 64, 64)]
F32_SHAPES = [((1, *sp), C, F) for sp, C, F in UNET3D_CONVS] \
    + [((1, *sp), F, C) for sp, C, F in UNET3D_CONVS] \
    + [((b, *sp), C, C) for b in (1, 4)
       for sp, C in (((160, 160, 96), 64), ((80, 80, 48), 128),
                     ((40, 40, 24), 256))] \
    + [((2, 5, 7, 19), 24, 40), ((1, 9, 13, 24), 24, 40),
       ((3, 11, 6, 24), 128, 64), ((1, 9, 12, 13), 64, 32),
       ((2, 3, 17, 5), 8, 8)]


def _decode_f32(plan):
    """Each block's (batch, x, y, z, channel) origin in the f32 kernel's
    order: channel tile fastest, then z, y, x and the batch."""
    nxt, nyt, nzt, ftiles = plan.tiles
    ids = np.arange(plan.blocks)
    ft, ids = ids % ftiles, ids // ftiles
    zt, ids = ids % nzt, ids // nzt
    yt, ids = ids % nyt, ids // nyt
    xt, b = ids % nxt, ids // nxt
    bx, by, bz = plan.brick
    return b, xt * bx, yt * by, zt * bz, ft * plan.tile


@pytest.mark.parametrize("shape,C,F", F32_SHAPES)
def test_conv_f32_plan_puts_every_output_in_one_block(shape, C, F):
    B, X, Y, Z = shape
    plan = k1.conv_f32_plan(B, X, Y, Z, C, F)
    b, x0, y0, z0, n0 = _decode_f32(plan)
    assert plan.blocks == B * np.prod(plan.tiles)
    origins = np.stack([b, x0, y0, z0, n0], 1)
    assert len(np.unique(origins, axis=0)) == plan.blocks
    # count, for every output voxel and channel, the blocks whose brick
    # and channel tile hold it
    bx, by, bz = plan.brick
    owners = np.zeros((B, X, Y, Z), int)
    per_block = np.zeros(plan.blocks, int)
    tiles_of = np.zeros((B, X, Y, Z, F), int) if B * X * Y * Z * F \
        <= 2_000_000 else None
    for i in range(plan.blocks):
        cut = (b[i], slice(x0[i], x0[i] + bx), slice(y0[i], y0[i] + by),
               slice(z0[i], z0[i] + bz))
        if n0[i] == 0:
            owners[cut] += 1
        per_block[i] = owners[cut].size
        if tiles_of is not None:
            tiles_of[cut + (slice(n0[i], n0[i] + plan.tile),)] += 1
    assert (owners == 1).all()
    assert (per_block > 0).all()          # no block starts outside
    if tiles_of is not None:
        assert (tiles_of == 1).all()
    assert sorted(set(n0.tolist())) == list(range(0, F, plan.tile))


@pytest.mark.parametrize("shape,C,F", F32_SHAPES)
def test_conv_f32_plan_fits_the_card(shape, C, F):
    plan = k1.conv_f32_plan(*shape, C, F)
    bx, by, bz = plan.brick
    assert plan.brick == k1.CONV_F32_BRICKS[plan.tile]
    assert bx * by * plan.tile // 8 == 256       # a thread per column, slot
    assert plan.smem_bytes <= k1.SMEM_LIMIT
    halo = (bx + 2) * (by + 2) * (bz + 2)
    stage = 4 * 8 * (27 * plan.tile + halo)       # 8-channel chunks
    assert plan.stages >= 2 and plan.stages * stage <= plan.smem_bytes
    assert bx * by * bz * (plan.tile + 4) * 4 <= plan.smem_bytes
    assert C % 8 == 0                             # whole 8-channel chunks


@pytest.mark.parametrize("shape,C,F", F32_SHAPES)
def test_conv_f32_plan_takes_the_narrow_tile_at_f32(shape, C, F):
    """A 32-wide channel tile where F <= 32 (no FMA on a channel beyond F),
    64 wide above."""
    plan = k1.conv_f32_plan(*shape, C, F)
    assert plan.tile == (32 if F <= 32 else 64)
    assert plan.tiles[3] * plan.tile - F < plan.tile
