"""The launch plan of K3's bf16 tensor-core variant (``dw_plan`` and the
tap-group table ``DW_GROUP_DX`` in ``gfe_mamba_torch/ops/cuda/conv3d.py``),
on the CPU: the splits take every 4x4x16 brick of the volume exactly
once, the groups' dx put every tap in exactly one group, and the
generator's three levels fill at least two waves of one block per SM on
an H100 (132 SMs in its SXM form, 114 in its PCIe form).
"""

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
