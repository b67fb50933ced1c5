"""The operation counters against torch.utils.flop_counter on the
reference at small sizes."""

import json

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.core import weights
from portbench.reference import gfe_mamba as ref
from portbench.reference.precision import Rounding
from portbench.reference.train import bce_dice
from portbench.reference.unet import unet3d_logits
from portbench.tests.tiny import FIXTURES

GFE = json.loads((FIXTURES / "configs" / "gfe_tiny.json").read_text())
UNET = json.loads((FIXTURES / "configs" / "unet_tiny.json").read_text())
Q = Rounding("f32")


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def gfe_params(requires=()):
    from portbench.entries.score import build_pipeline
    shapes = weights.parameter_shapes(build_pipeline(GFE, "meta"))
    P = weights.draw(shapes, 1, "cpu", torch.float32)
    return {k: v.clone().requires_grad_(k.startswith(requires))
            for k, v in P.items()} if requires else P


def gfe_inputs(b):
    g = torch.Generator().manual_seed(0)
    mri = torch.randn(b, *GFE["img_size"], 1, generator=g)
    cats = torch.stack([torch.randint(0, c, (b,), generator=g)
                        for c in GFE["head"]["categories"]], -1)
    num = torch.randn(b, GFE["head"]["num_continuous"], generator=g)
    return mri, cats, num


@pytest.mark.parametrize("b", [1, 2])
def test_gfe_forward(b):
    P = gfe_params()
    with torch.no_grad():
        n = counted(lambda: ref.forward(P, *gfe_inputs(b), GFE, Q))
    assert work.total(work.gfe_mamba_ops(GFE, b), step=False) == n


def test_gfe_stage2_step():
    P = gfe_params(("combiner.", "classifier."))
    mri, cats, num = gfe_inputs(2)
    h = GFE["head"]

    def step():
        with torch.no_grad():
            mi, mo, pet = ref.generator(ref.sub(P, "generator"), mri, GFE, Q)
        feat = ref.combiner(ref.sub(P, "combiner"), mi, mo, Q)
        logits = ref.classifier(ref.sub(P, "classifier"), cats, num, feat,
                                [mri, pet], categories=h["categories"],
                                depth=h["depth"], heads=h["heads"], q=Q)
        F.binary_cross_entropy_with_logits(
            logits, torch.ones(2)).backward()
    ops = work.gfe_mamba_ops(GFE, 2, "stage2")
    # torch's counter takes a grouped conv's weight gradient as if it
    # were ungrouped: the depthwise conv1d's, groups = ED, ED times over
    ed = h["expand"] * h["dim"]
    over = sum((ed - 1) * o.flops for o in ops if o.name.endswith("conv1d"))
    assert work.total(ops, True) == counted(step) - over


def test_unet3d_step():
    from portbench.entries.seg_train import draw_rows
    from gfe_mamba_torch.models.unet3d import get_model
    m = get_model(dict(name="UNet3D", in_channels=1, out_channels=1,
                       f_maps=UNET["f_maps"], num_levels=UNET["num_levels"]))
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in m.named_parameters()}
    raw, label = draw_rows(UNET, 1, 0, "cpu")[0]

    def step():
        logits = unet3d_logits(P, raw.permute(0, 4, 1, 2, 3), levels=4, q=Q)
        bce_dice(logits, label.permute(0, 4, 1, 2, 3)).backward()
    assert work.total(work.unet3d_ops(UNET, 1, True), True) == counted(step)
    with torch.no_grad():
        fwd = counted(lambda: unet3d_logits(P, raw.permute(0, 4, 1, 2, 3),
                                            levels=4, q=Q))
    assert work.total(work.unet3d_ops(UNET, 1, True), False) == fwd


@pytest.mark.parametrize("residual", [False, True])
def test_conv3d_work(residual):
    x = torch.randn(2, 6, 5, 4, 8)
    w = torch.randn(16, 8, 3, 3, 3)
    n = counted(lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1))
    flops, nbytes = work.conv3d_work(tuple(x.shape), tuple(w.shape), 2,
                                     residual=residual)
    assert flops == n
    vox = 2 * 6 * 5 * 4
    assert nbytes == 2 * (vox * (8 + 16 + (16 if residual else 0))
                          + 27 * 8 * 16)


def test_least_time_is_the_larger_bound():
    assert work.conv3d_least_s(10, 1, 10.0, 1.0) == 1.0
    assert work.conv3d_least_s(10, 100, 10.0, 1.0) == 100.0
