"""The port's spans (``utils/profiling.py``): ``annotate`` is one shared
no-op context without a profiler and a ``record_function`` under one;
``to_host`` is ``float`` / ``bool``.  Under ``torch.profiler`` on the CPU
one step of each trainer opens one ``gfe.step`` holding its forward,
backward, update and host syncs; the scoring forward opens its generator
and classifier spans, one ``gfe.conv3d`` per ``SingleConv`` call and one
``gfe.scan`` per Mamba layer; a conv's backward opens its dz and dw
spans.  Tracing changes no number a step computes.

Tiny models as in ``test_torch_train_stage1.py``,
``test_torch_train_stage2.py`` and ``test_torch_seg_train.py``, f32."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.mamba import MambaBlock
from gfe_mamba_torch.models.pipeline import build_generator, build_gfe_mamba
from gfe_mamba_torch.models.unet3d import get_model
from gfe_mamba_torch.ops.blocks import SingleConv
from gfe_mamba_torch.ops.conv3d import conv3x3x3
from gfe_mamba_torch.segmentation.trainer import UNetTrainer
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.utils import profiling

torch.set_num_threads(2)

IMG = (16, 16, 8)
GEN = dict(f_maps=(8, 16, 32), layer_order="gcr", fold_factor=2,
           vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
           vit_mlp_dim=32)
CLS = dict(categories=(3, 5, 2), num_continuous=4, dim=64, depth=2, heads=2)
PHASES = ("gfe.forward", "gfe.backward", "gfe.update")


def _stage1(tmp_path):
    disc = PatchDiscriminator(2, 4)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    trainer = GanTrainer(build_generator(img_size=IMG, device="cpu", seed=0,
                                         **GEN),
                         disc, PerceptualLoss(0.5, device="cpu"),
                         mixed_precision="none", device="cpu", seed=3)
    g = torch.Generator().manual_seed(5)
    mri, pet = (torch.randn(1, *IMG, 1, generator=g) for _ in range(2))
    return trainer, lambda: trainer.train_step(mri, pet, 1.0), \
        trainer.g_params


def _stage2(tmp_path):
    model = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2,
                            cross_ff_dropout=0.0, **GEN, **CLS)
    trainer = ClassifyTrainer(model, mixed_precision="none", device="cpu",
                              seed=3)
    g = torch.Generator().manual_seed(5)
    batch = (torch.randn(2, *IMG, 1, generator=g),
             torch.randint(0, 2, (2, 3), generator=g),
             torch.randn(2, 4, generator=g), torch.tensor([1.0, 0.0]))
    return trainer, lambda: trainer.train_step(*batch), trainer.trainable


def _seg(tmp_path):
    model = get_model(dict(name="UNet3D", f_maps=8, num_levels=2,
                           num_groups=2), seed=4)
    trainer = UNetTrainer(model, {"loss": {"name": "BCEDiceLoss"},
                                  "eval_metric": {"name": "DiceCoefficient"},
                                  "optimizer": {"name": "Adam",
                                                "learning_rate": 1e-3}},
                          str(tmp_path), device="cpu")
    trainer.init_state(seed=4)
    g = torch.Generator().manual_seed(5)
    raw = torch.randn(1, 8, 8, 8, 1, generator=g)
    label = (torch.rand(1, 8, 8, 8, 1, generator=g) > 0.5).float()
    return trainer, lambda: trainer.train_step(raw, label), \
        dict(model.named_parameters())


# how each trainer is built, and its host syncs per step at accum_steps 1
TRAINERS = {"GanTrainer": (_stage1, 6), "ClassifyTrainer": (_stage2, 3),
            "UNetTrainer": (_seg, 1)}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.name.startswith("gfe."))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_annotate_is_one_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a = profiling.annotate("gfe.x")
    assert a is profiling.annotate("gfe.y", "args")
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("gfe.x") is not a


@pytest.mark.parametrize("x,want", [
    (torch.tensor(0.1), float(torch.tensor(0.1))),
    (torch.tensor([2.5], dtype=torch.float64), 2.5),
    (torch.tensor(True), True), (torch.tensor(False), False), (3, 3.0)])
def test_to_host_is_float_or_bool(x, want):
    got = profiling.to_host(x, "test")
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", list(TRAINERS))
def test_one_step_opens_its_phases_inside_one_step_span(tmp_path, name):
    build, syncs = TRAINERS[name]
    trainer, step, _ = build(tmp_path)
    step()                                   # Adam's state exists
    _, spans = _profiled(step)
    steps = _named(spans, "gfe.step")
    assert len(steps) == 1
    for phase in PHASES:
        found = _named(spans, phase)
        assert found, phase
        assert all(_inside(s, steps[0]) for s in found), phase
    sync = [s for s in spans if s[0].startswith("gfe.sync.")]
    assert len(sync) == syncs, [s[0] for s in sync]
    assert all(_inside(s, steps[0]) for s in sync)
    # the update comes after the last backward
    assert min(s[1] for s in _named(spans, "gfe.update")) >= \
        max(s[2] for s in _named(spans, "gfe.backward"))


@pytest.mark.parametrize("name", list(TRAINERS))
def test_tracing_changes_no_number(tmp_path, name):
    """Two trainers built alike take two steps, one of them traced: the
    returned losses and the parameters after are bitwise equal."""
    build = TRAINERS[name][0]
    runs = []
    for traced in (False, True):
        _, step, params = build(tmp_path / str(traced))
        outs = [step(), _profiled(step)[0] if traced else step()]
        runs.append((outs, {n: p.detach().clone()
                            for n, p in params.items()}))
    (plain, plain_p), (traced, traced_p) = runs
    assert plain == traced
    for n in plain_p:
        assert torch.equal(plain_p[n], traced_p[n]), n


def test_scoring_forward_opens_its_layer_spans():
    model = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2, **GEN,
                            **CLS)
    calls = {"conv": 0, "mamba": 0}

    def count(key):
        def hook(*_):
            calls[key] += 1
        return hook

    for m in model.modules():
        if isinstance(m, SingleConv):
            m.register_forward_hook(count("conv"))
        if isinstance(m, MambaBlock):
            m.register_forward_hook(count("mamba"))
    g = torch.Generator().manual_seed(5)
    args = (torch.randn(2, *IMG, 1, generator=g),
            torch.randint(0, 2, (2, 3), generator=g),
            torch.randn(2, 4, generator=g))
    with torch.no_grad():
        _, spans = _profiled(lambda: model(*args))
    generator, classifier = (_named(spans, n)
                             for n in ("gfe.generator", "gfe.classifier"))
    assert len(generator) == 1 and len(classifier) == 1
    assert generator[0][2] <= classifier[0][1]
    convs = _named(spans, "gfe.conv3d")
    assert calls["conv"] > 0 and len(convs) == calls["conv"]
    assert all(_inside(s, generator[0]) for s in convs)
    scans = _named(spans, "gfe.scan")
    assert calls["mamba"] == CLS["depth"] and len(scans) == calls["mamba"]
    assert all(_inside(s, classifier[0]) for s in scans)


def test_conv_backward_opens_dz_and_dw():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 4, 4, 4, 3, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 3, 3, 2, generator=g, requires_grad=True)

    def backward():
        return torch.autograd.grad(conv3x3x3(x, w, act="relu").sum(),
                                   (x, w))
    grads, spans = _profiled(backward)
    assert sorted(s[0] for s in spans) == ["gfe.conv3d.dw", "gfe.conv3d.dz"]
    np.testing.assert_array_equal(backward()[0].numpy(), grads[0].numpy())
