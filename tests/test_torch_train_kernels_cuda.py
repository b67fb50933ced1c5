"""The port's training kernels on the card: K4 (scan backward) and K3
(conv weight gradient) against their plain PyTorch versions, the conv
and scan autograd Functions against autograd through the plain
forwards, and small training steps that must launch the kernels.  Every
test needs an NVIDIA GPU (``cuda`` marker) and skips without one.  The
file imports torch and the port only, so it also runs where JAX is not
installed::

    python -m pytest --noconftest tests/test_torch_train_kernels_cuda.py -q

Tolerances, relative to max(1, max |plain|): K4 1e-4 (f32 state on both
sides; dA/dB/dC/dD summed in other orders), and one bf16 ulp for its bf16
outputs against the plain f32 result rounded once, K3 1e-4 in f32 and bf16
(both sides form the same zhat and sum the same products, exact in f32,
in other orders), the autograd Functions 1e-3 (bf16-free f32 paths,
cuDNN vs the kernels' accumulation order).
"""

import math

import numpy as np
import pytest
import torch

from gfe_mamba_torch.ops import conv3d as ops_conv
from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.ops.scan import selective_scan
from gfe_mamba_torch.testing import bf16_ulps, mamba_scan_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rel, name=""):
    got, want = got.float(), want.float().to(got.device)
    assert got.shape == want.shape, name
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), (name, err)


def _randn(gen, *shape, scale=1.0):
    if isinstance(gen, torch.Generator):
        return torch.randn(*shape, generator=gen, device=gen.device) * scale
    return torch.from_numpy((gen.randn(*shape) * scale).astype(np.float32))


def _generator(seed, voxels, device):
    """The inputs' source: numpy's generator for the small volumes, and a
    seeded one on the card past 2^15 voxels (the generator's levels),
    which numpy would draw on the host for minutes."""
    if voxels <= 2 ** 15:
        return np.random.RandomState(seed)
    return torch.Generator(device=device).manual_seed(seed)


def _scan_args(gen, bsz, L, ED, N, gate, bias, softplus, device):
    delta = _randn(gen, bsz, L, ED, scale=0.5)
    if not softplus:             # a real step is positive without softplus
        delta = delta.abs()
    args = [_randn(gen, bsz, L, ED), delta, -_randn(gen, ED, N).abs(),
            _randn(gen, bsz, L, N), _randn(gen, bsz, L, N),
            _randn(gen, ED), _randn(gen, bsz, L, ED) if gate else None,
            _randn(gen, ED, scale=0.1) if bias else None]
    return [None if t is None else t.to(device) for t in args]


@pytest.mark.parametrize("bsz", [1, 2, 4])
@pytest.mark.parametrize("ED,N", [(1024, 16), (1000, 16), (1001, 16),
                                  (256, 8)])
@pytest.mark.parametrize("gate,bias,softplus", [
    (True, True, True), (False, False, True), (True, False, False)])
def test_scan_bwd_kernel_matches_plain(cuda, gate, bias, softplus, ED, N,
                                       bsz):
    """Batch 1 (the Stage-2 step) to 4, every flag on and off; ED = 1001
    leaves one channel in the last block of 4."""
    gen = np.random.RandomState(0)
    args = _scan_args(gen, bsz, 53, ED, N, gate, bias, softplus, cuda)
    g = _randn(gen, bsz, 53, ED).to(cuda)
    got = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=softplus)
    want = k2.selective_scan_bwd_plain(*args, g, delta_softplus=softplus)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "ddelta", "dA", "dB", "dC", "dD", "dz",
                           "dbias"), got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            _assert_close(a, b, 1e-4, name)


@pytest.mark.parametrize("d_model", [128, 512])
@pytest.mark.parametrize("bsz", [1, 4])
def test_scan_bwd_kernel_takes_bf16_views_and_is_deterministic(cuda, bsz,
                                                                d_model):
    """A Mamba layer's own bf16 operands (views, channel-major x) go in as
    they are: dx, ddelta, dz come back in bf16 within one bf16 ulp of the
    plain f32 result rounded once, the f32 gradients within 1e-4; a second
    call is bitwise equal to the first.  d_model 512 is the canonical
    head's (ED 1024)."""
    args = mamba_scan_operands(bsz, 53, d_model, torch.bfloat16, cuda,
                               seed=bsz)
    assert not args[0].is_contiguous() and not args[6].is_contiguous()
    g = _randn(np.random.RandomState(9), bsz, 53, 2 * d_model).to(
        cuda, torch.bfloat16)
    got = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    again = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    want = k2.selective_scan_bwd_plain(*[t.float() for t in args],
                                       g.float(), delta_softplus=True)
    torch.cuda.synchronize()
    for i, name in enumerate(("dx", "ddelta", "dA", "dB", "dC", "dD", "dz",
                              "dbias")):
        assert torch.equal(got[i], again[i]), name
        if name in ("dx", "ddelta", "dz"):
            assert got[i].dtype == torch.bfloat16, name
            assert bf16_ulps(got[i], want[i]) <= 1.0, name
        else:
            assert got[i].dtype == torch.float32, name
            _assert_close(got[i], want[i], 1e-4, name)


@pytest.mark.parametrize("d_model", [128, 512])
@pytest.mark.parametrize("bsz", [1, 2, 4])
def test_scan_kernels_take_the_stage2_f32_views(cuda, bsz, d_model):
    """The bf16 Stage-2 step's operands (f32 tokens into a bf16 Mamba
    layer, which computes in f32: x, delta, z, B, C f32 views, D and
    delta_bias bf16) go to K2 and K4 as they are: y and every gradient
    within 1e-5 / 1e-4 of the plain versions in f32, a second K4 call
    bitwise equal to the first.  d_model 512 is the canonical head's."""
    args = mamba_scan_operands(bsz, 53, d_model, torch.bfloat16, cuda,
                               seed=bsz, input_dtype=torch.float32)
    assert args[0].dtype == torch.float32 and args[5].dtype == torch.bfloat16
    assert not args[0].is_contiguous() and not args[6].is_contiguous()
    assert all(k2.kernel_operand(t) is t for t in args)
    plain = [t.float() for t in args]
    got = k2.selective_scan_cuda(*args, delta_softplus=True)
    want = k2.selective_scan_plain(*plain, delta_softplus=True)
    assert got.dtype == torch.float32
    _assert_close(got, want, 1e-5, "y")
    g = _randn(np.random.RandomState(7), bsz, 53, 2 * d_model).to(cuda)
    got = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    again = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    want = k2.selective_scan_bwd_plain(*plain, g, delta_softplus=True)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dx", "ddelta", "dA", "dB", "dC", "dD", "dz",
                              "dbias"), got, want, again):
        assert a.dtype == torch.float32, name
        assert torch.equal(a, c), name
        _assert_close(a, b, 1e-4, name)


def test_scan_fn_takes_bf16_views_without_casts_or_copies(cuda):
    """``SelectiveScanFn`` forward and backward on a Mamba layer's own
    bf16 operands: no op casts anything to f32 and none copies (``clone``,
    ``copy_``, ``contiguous``); the only casts are the f32 dB, dC, dD and
    ddelta_bias back to bf16.  K2 and K4 launch once each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ops.append((func, kwargs.get("dtype")))
            return func(*args, **kwargs)

    leaves = [t.detach().requires_grad_()
              for t in mamba_scan_operands(1, 53, 128, torch.bfloat16, cuda,
                                           seed=1)]
    g = _randn(np.random.RandomState(5), 1, 53, 256).to(cuda,
                                                         torch.bfloat16)
    k2.launches = k2.bwd_launches = 0
    with Record() as rec:
        # autograd.grad, not backward: a leaf's AccumulateGrad would copy
        # the contiguous dx into channel-major x's layout
        grads = torch.autograd.grad(
            selective_scan(*leaves, delta_softplus=True), leaves, g)
        torch.cuda.synchronize()
    assert (k2.launches, k2.bwd_launches) == (1, 1)
    casts = [dtype for func, dtype in rec.ops
             if func is torch.ops.aten._to_copy.default]
    copies = [func for func, _ in rec.ops if func in (
        torch.ops.aten.clone.default, torch.ops.aten.copy_.default)]
    assert casts == [torch.bfloat16] * 4 and not copies, (casts, copies)
    assert all(d.dtype == t.dtype for d, t in zip(grads, leaves))


def _dw_args(gen, shape, C, F, affine, dtype, device):
    x = _randn(gen, *shape, C).to(device, dtype)
    g1 = _randn(gen, *shape, F).to(device, dtype)
    a = (_randn(gen, shape[0], C).abs() + 0.5).to(device) if affine else None
    s = _randn(gen, shape[0], C).to(device) if affine else None
    return x, g1, a, s


# bf16 takes the tensor-core variant (4x4x16 bricks, 64x64 tiles): bricks
# ragged in every axis with C, F below one tile; C != F over two channel
# tiles; the 256-channel level's Z = 24 (a half-empty second z brick);
# the segmentation UNet3D's widths (C != F, the concat-joined 192, 384
# and 768 inputs); the generator's three levels at batch 1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,C,F,affine", [
    ((1, 20, 20, 12), 64, 64, True), ((2, 5, 7, 19), 24, 40, True),
    ((2, 5, 7, 19), 24, 40, False), ((2, 9, 13, 21), 24, 40, True),
    ((2, 9, 13, 21), 24, 40, False), ((1, 6, 7, 20), 128, 64, True),
    ((1, 6, 7, 20), 128, 64, False), ((1, 8, 8, 24), 256, 256, True),
    ((1, 8, 8, 24), 256, 256, False), ((1, 8, 12, 16), 32, 64, True),
    ((1, 6, 8, 8), 192, 64, True), ((1, 4, 8, 8), 384, 128, True),
    ((1, 4, 4, 8), 768, 256, False), ((1, 160, 160, 96), 64, 64, True),
    ((1, 160, 160, 96), 64, 64, False), ((1, 80, 80, 48), 128, 128, True),
    ((1, 80, 80, 48), 128, 128, False), ((1, 40, 40, 24), 256, 256, True),
    ((1, 40, 40, 24), 256, 256, False)])
def test_dw_kernel_matches_plain(cuda, dtype, shape, C, F, affine):
    gen = _generator(1, math.prod(shape), cuda)
    x, g1, a, s = _dw_args(gen, shape, C, F, affine, dtype, cuda)
    got = k1.conv3x3x3_dw_cuda(x, g1, a, s)
    want = k1.conv3x3x3_dw_plain(x, g1, a, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _assert_close(got, want, 1e-4)


def test_dw_kernel_is_deterministic_and_counts_its_variant(cuda):
    """Two bf16 calls on the same inputs give bitwise-identical dw (split
    partials summed in a fixed order, no atomics); a bf16 call launches
    the tensor-core variant and an f32 call the CUDA-core one."""
    gen = np.random.RandomState(4)
    x, g1, a, s = _dw_args(gen, (1, 9, 13, 40), 128, 64, True,
                           torch.bfloat16, cuda)
    k1.dw_launches = k1.dw_mma_launches = k1.dw_fma_launches = 0
    first = k1.conv3x3x3_dw_cuda(x, g1, a, s)
    second = k1.conv3x3x3_dw_cuda(x, g1, a, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert (k1.dw_launches, k1.dw_mma_launches, k1.dw_fma_launches) \
        == (2, 2, 0)
    k1.conv3x3x3_dw_cuda(x.float(), g1.float(), a, s)
    torch.cuda.synchronize()
    assert (k1.dw_launches, k1.dw_mma_launches, k1.dw_fma_launches) \
        == (3, 2, 1)


def test_dw_f32_kernel_is_deterministic(cuda):
    """Two f32 calls on the same inputs give bitwise-identical dw: each
    block sums its bricks in a fixed order, the split partials are summed
    in a fixed order, no atomics.  The volume has several splits at a
    segmentation width (192 -> 64)."""
    gen = np.random.RandomState(5)
    x, g1, a, s = _dw_args(gen, (1, 16, 32, 48), 192, 64, True,
                           torch.float32, cuda)
    assert k1.dw_fma_plan(1, 16, 32, 48, 192, 64,
                          k1._sm_count(cuda.index or 0)).splits > 1
    first = k1.conv3x3x3_dw_cuda(x, g1, a, s)
    second = k1.conv3x3x3_dw_cuda(x, g1, a, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape,C,scale", [((2, 6, 10, 12), 16, 0.05),
                                           ((1, 80, 80, 48), 128,
                                            (27 * 128) ** -0.5)])
@pytest.mark.parametrize("act,with_res,post_act", [
    ("elu", False, "none"), ("none", True, "elu")])
def test_conv_function_matches_autograd_of_plain(cuda, act, with_res,
                                                 post_act, shape, C,
                                                 scale):
    """Conv3x3x3Fn on CUDA tensors (K1 forward, K1 as dz, K3 as dw)
    against torch.autograd through the plain forward, f32, on a small
    volume and at the generator's 128-channel level.  elu, whose
    derivative is continuous at 0: a relu output within rounding of 0 can
    take opposite masks in the two forwards."""
    gen = _generator(2, math.prod(shape), cuda)
    F, B = C, shape[0]
    base = [_randn(gen, *shape, C),
            _randn(gen, 3, 3, 3, C, F, scale=scale),
            None, _randn(gen, B, C).abs() + 0.5, _randn(gen, B, C),
            _randn(gen, *shape, F) if with_res else None]
    g = _randn(gen, *shape, F).to(cuda)
    grads = []
    for fn in (ops_conv.conv3x3x3, k1.conv3x3x3_plain):
        ins = [None if t is None else t.to(cuda, copy=True).requires_grad_()
               for t in base]
        fn(*ins, act, post_act).backward(g)
        grads.append([None if t is None else t.grad for t in ins])
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dw", "dbias", "da", "ds", "dres"),
                          *grads):
        if b is not None:
            _assert_close(a, b, 1e-3, name)


def test_cuda_tensors_upstream_of_the_kernels_get_gradients(cuda):
    """A CUDA tensor before a scan or a conv receives a finite gradient,
    through K4, K1 (dz) and K3 (dw)."""
    gen = np.random.RandomState(3)
    args = _scan_args(gen, 1, 9, 64, 16, True, True, True, cuda)
    args = [None if t is None else t.requires_grad_() for t in args]
    k2.bwd_launches = 0
    selective_scan(*args, delta_softplus=True).sum().backward()
    assert k2.bwd_launches == 1
    assert all(torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
               for t in args)
    x = _randn(gen, 1, 4, 4, 8, 8).to(cuda).requires_grad_()
    w = _randn(gen, 3, 3, 3, 8, 8, scale=0.1).to(cuda).requires_grad_()
    k1.launches = k1.dw_launches = 0
    ops_conv.conv3x3x3(x, w, act="relu").sum().backward()
    assert (k1.launches, k1.dw_launches) == (2, 1)
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


def test_training_steps_launch_the_kernels(cuda):
    """One small Stage-2 and one small Stage-1 step on the card: K4 once
    per Mamba layer; K1 twice and K3 once per generator conv."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import (build_generator,
                                                 build_gfe_mamba)
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    tiny = dict(img_size=(16, 16, 8), f_maps=(8, 16, 32), fold_factor=2,
                vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
                vit_mlp_dim=32, device=cuda)
    model = build_gfe_mamba(categories=(3, 2), num_continuous=3, dim=64,
                            depth=2, heads=2, seq_length=2, **tiny)
    trainer = ClassifyTrainer(model, device=cuda)
    k2.bwd_launches = 0
    logs = trainer.train_step(torch.randn(2, 16, 16, 8, 1),
                              torch.zeros(2, 2, dtype=torch.long),
                              torch.ones(2, 3), torch.tensor([0.0, 1.0]))
    assert np.isfinite(logs["cla_loss"]) and logs["skipped"] == 0.0
    assert k2.bwd_launches == 2

    disc = PatchDiscriminator(2, 4)
    disc.reset_parameters(torch.Generator().manual_seed(0))
    gan = GanTrainer(build_generator(**tiny), disc,
                     PerceptualLoss(0.5, device=cuda), device=cuda)
    k1.launches = k1.dw_launches = 0
    logs = gan.train_step(torch.randn(1, 16, 16, 8, 1),
                          torch.randn(1, 16, 16, 8, 1), 1.0)
    assert all(np.isfinite(v) for v in logs.values())
    assert logs["skipped"] == 0.0
    assert (k1.launches, k1.dw_launches) == (20, 10)
