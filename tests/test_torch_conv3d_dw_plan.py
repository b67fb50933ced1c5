"""The launch plans of K3 (``dw_plan`` for the bf16 tensor-core variant,
``dw_fma_plan`` for the f32 CUDA-core one, and the tap-group table
``DW_GROUP_DX`` in ``gfe_mamba_torch/ops/cuda/conv3d.py``), on the CPU:
the splits take every brick of the volume exactly once, the groups' dx
put every tap in exactly one group and the blocks every (split, tap, c,
f) of the partials; the generator's three levels fill at least two waves
of one block per SM on an H100 (132 SMs in its SXM form, 114 in its PCIe
form) in bf16; in f32 two stages fit a block's shared memory and the
segmentation path's splits fill whole waves.
"""

import numpy as np
import pytest

from gfe_mamba_torch.ops.cuda import conv3d as k1

# the Stage-1 generator's three levels (batch 1) and ragged volumes
SHAPES = [((1, 160, 160, 96), 64, 64), ((1, 80, 80, 48), 128, 128),
          ((1, 40, 40, 24), 256, 256), ((2, 9, 13, 21), 24, 40),
          ((3, 5, 1, 17), 128, 64)]


def _bricks(B, X, Y, Z):
    return B * -(-X // 4) * -(-Y // 4) * -(-Z // 16)


@pytest.mark.parametrize("shape,C,F", SHAPES)
def test_dw_plan_puts_every_brick_in_one_split(shape, C, F):
    per, splits = k1.dw_plan(*shape, C, F, sms=132)
    bricks = _bricks(*shape)
    # split s takes bricks [s * per, min(bricks, (s + 1) * per))
    taken = [range(s * per, min(bricks, (s + 1) * per))
             for s in range(splits)]
    assert [i for r in taken for i in r] == list(range(bricks))
    assert all(len(r) > 0 for r in taken)
    assert splits <= 65535


def test_dw_group_table_puts_every_tap_in_one_group():
    # group g serves taps 9 dx + 3 dy + dz for its dx and every (dy, dz)
    taps = [9 * dx + t for dx in k1.DW_GROUP_DX for t in range(9)]
    assert sorted(taps) == list(range(27))
    assert all(0 <= dx <= 2 for dx in k1.DW_GROUP_DX)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,C,F", SHAPES[:3])
def test_dw_plan_fills_two_waves_at_the_generator_levels(shape, C, F, sms):
    per, splits = k1.dw_plan(*shape, C, F, sms=sms)
    blocks = splits * len(k1.DW_GROUP_DX) * -(-C // 64) * -(-F // 64)
    assert blocks >= 2 * sms


# K3's f32 launch (``dw_fma_plan``): the segmentation UNet3D's 13 K1 convs
# (f_maps 64, a 64x128x128 patch, batch 1), the generator's three levels at
# batch 1 and 4, and ragged volumes
UNET3D_CONVS = [((64, 128, 128), 32, 64), ((32, 64, 64), 64, 64),
                ((32, 64, 64), 64, 128), ((16, 32, 32), 128, 128),
                ((16, 32, 32), 128, 256), ((8, 16, 16), 256, 256),
                ((8, 16, 16), 256, 512), ((16, 32, 32), 768, 256),
                ((16, 32, 32), 256, 256), ((32, 64, 64), 384, 128),
                ((32, 64, 64), 128, 128), ((64, 128, 128), 192, 64),
                ((64, 128, 128), 64, 64)]
GENERATOR = [((b, *sp), C, C) for b in (1, 4)
             for sp, C in (((160, 160, 96), 64), ((80, 80, 48), 128),
                           ((40, 40, 24), 256))]
F32_SHAPES = [((1, *sp), C, F) for sp, C, F in UNET3D_CONVS] + GENERATOR \
    + [((2, 9, 13, 21), 24, 40), ((3, 5, 1, 17), 128, 64),
       ((1, 6, 7, 20), 8, 72)]


def _fma_bricks(B, X, Y, Z):
    bx, by, bz = k1.DW_F32_BRICK
    return B * -(-X // bx) * -(-Y // by) * -(-Z // bz)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,C,F", F32_SHAPES)
def test_dw_fma_plan_puts_every_element_in_one_block(shape, C, F, sms):
    """Split s takes bricks [s * per, (s + 1) * per): every brick in one
    split; the blocks of a split, decoded as the kernel does (group
    fastest, then the f tile and the c tile), put every (tap, c, f) of its
    partial in exactly one block."""
    plan = k1.dw_fma_plan(*shape, C, F, sms=sms)
    bricks = _fma_bricks(*shape)
    taken = [range(s * plan.per, min(bricks, (s + 1) * plan.per))
             for s in range(plan.splits)]
    assert [i for r in taken for i in r] == list(range(bricks))
    assert all(len(r) > 0 for r in taken)
    assert plan.splits <= 65535
    groups, ctiles, ftiles = len(k1.DW_GROUP_DX), -(-C // 64), -(-F // 64)
    cover = np.zeros((27, C, F), int)
    for block in range(groups * ctiles * ftiles):
        dx = k1.DW_GROUP_DX[block % groups]
        ft, ct = (block // groups) % ftiles, block // groups // ftiles
        cover[9 * dx:9 * dx + 9, 64 * ct:64 * ct + 64,
              64 * ft:64 * ft + 64] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape,C,F", F32_SHAPES)
def test_dw_fma_plan_fits_the_card(shape, C, F):
    """Two stages of a brick's x slab (the rows of one dx's 9 taps) and g1
    rows, 64 channels of f32 each, in one block's shared memory."""
    plan = k1.dw_fma_plan(*shape, C, F, sms=132)
    bx, by, bz = plan.brick
    rows = bx * (by + 2) * (bz + 2) + bx * by * bz
    assert plan.stages >= 2
    assert plan.smem_bytes == plan.stages * rows * 64 * 4
    assert plan.smem_bytes <= k1.SMEM_LIMIT


@pytest.mark.parametrize("shape,C,F",
                         [((1, *sp), C, F) for sp, C, F in UNET3D_CONVS]
                         + GENERATOR)
def test_dw_fma_plan_fills_whole_waves_at_the_path_shapes(shape, C, F):
    """One block per SM of an H100 SXM (132 SMs): waves x bricks per block
    stays within 5% of the bricks' share of the card."""
    plan = k1.dw_fma_plan(*shape, C, F, sms=132)
    tiles = len(k1.DW_GROUP_DX) * -(-C // 64) * -(-F // 64)
    waves = -(-plan.splits * tiles // 132)
    assert waves * plan.per <= 1.05 * _fma_bricks(*shape) * tiles / 132
