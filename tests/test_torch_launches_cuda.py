"""The kernels each canonical path launches, on the card, at the sizes the
benchmark runs: a scoring request of each Stage-2 head, a Stage-2 step of
the Mamba and Jamba heads, a Stage-1 step, ``group_norm_act`` at the
generator's widths and the prefill of a Jamba2-Mini-shaped stack, the
models built by ``gfe_mamba_torch/testing.py`` (as ``chip_smoke.py``
builds them; the UNet3D step's launches are ``test_torch_seg_cuda.py::
test_seg_train``'s).  Every test needs an NVIDIA GPU
(``cuda`` marker) and skips without one; the file imports torch and the
port only::

    python -m pytest --noconftest -m cuda tests/test_torch_launches_cuda.py -q
"""

import contextlib
import math

import pytest
import torch

from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.testing import CANONICAL_IMG as IMG
from gfe_mamba_torch.testing import SCORE_BATCH as BATCH
from gfe_mamba_torch.testing import (assert_close, docqa_prompt,
                                     jamba2_mini_stack, launch_counts,
                                     launches_since, scoring_model,
                                     scoring_request, stage1_step,
                                     stage1_trainer, stage2_step,
                                     stage2_trainer)

pytestmark = pytest.mark.cuda

# K2 per forward and K4 per Stage-2 step: the Mamba head's 6 layers, the
# Jamba head's 11 Mamba layers (12 layers, layer 4 attention), none for
# the transformer
SCANS = {"mamba": 6, "jamba": 11, "transformer": 0}
# the generator's GroupNorm widths, 8 groups
GN_WIDTHS = (((160, 160, 96), 64), ((80, 80, 48), 128), ((40, 40, 24), 256))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("mixer", list(SCANS))
def test_scoring_requests_launch_the_kernels(cuda, mixer):
    """Three requests of batch 4 at the canonical size in bf16: each
    launches K1 10 times, all on the wgmma variant, and K2 once per Mamba
    layer of its head, none on the long kernel (53 steps); the logits and
    the PET finite and of their shapes."""
    model = scoring_model(cuda, mixer)
    gen = torch.Generator(device=cuda)
    for seed in range(3):
        gen.manual_seed(seed)
        before = launch_counts()
        logits, pet = scoring_request(model, gen)
        n = launches_since(before)
        assert logits.shape == (BATCH, 1) and pet.shape == (BATCH, *IMG, 1)
        assert torch.isfinite(logits).all() and torch.isfinite(pet).all()
        assert (n["K1"], n["K1.mma"], n["K1.fma"], n["K2"], n["K2.long"]) \
            == (10, 10, 0, SCANS[mixer], 0)


@contextlib.contextmanager
def _scan_operands_seen():
    """Every K2 and K4 launch of ``SelectiveScanFn`` in the block with the
    operands it was handed (``[(args, kwargs)]`` per kernel)."""
    from gfe_mamba_torch.ops import scan as ops_scan

    seen = {"K2": [], "K4": []}
    saved = ops_scan.selective_scan_cuda, ops_scan.selective_scan_bwd_cuda

    def record(name, fn):
        def call(*args, **kwargs):
            seen[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    ops_scan.selective_scan_cuda = record("K2", saved[0])
    ops_scan.selective_scan_bwd_cuda = record("K4", saved[1])
    try:
        yield seen
    finally:
        ops_scan.selective_scan_cuda, ops_scan.selective_scan_bwd_cuda = saved


@pytest.mark.parametrize("mixer", ["mamba", "jamba"])
def test_stage2_steps_launch_the_kernels(cuda, mixer):
    """``ClassifyTrainer`` at the canonical size in bf16, batch 1, dropout
    on, a warm-up then three steps: each launches K1 10 times and K2 and
    K4 once per Mamba layer, finite and not skipped.  The mixer's output
    is f32 (the classifier computes in f32 under the bf16 cast, as JAX's),
    so K2 and K4 are handed f32 x, delta, B, C and z (and K4 an f32
    cotangent) beside the bf16 D and delta_bias; each kernel on the last
    step's first-layer operands agrees with its plain version (1e-5 for
    y, 1e-4 for the gradients)."""
    trainer = stage2_trainer(cuda, mixer)
    gen = torch.Generator(device=cuda)
    dtypes = set()
    trainer.model.classifier.transformer.register_forward_hook(
        lambda m, i, o: dtypes.add(
            (o[0] if isinstance(o, tuple) else o).dtype))
    stage2_step(trainer, gen.manual_seed(200))
    scans = SCANS[mixer]
    for seed in range(3):
        torch.cuda.synchronize()
        before = launch_counts()
        with _scan_operands_seen() as seen:
            logs = stage2_step(trainer, gen.manual_seed(seed))
            n = launches_since(before)
        assert math.isfinite(logs["cla_loss"]) and not logs["skipped"]
        assert (n["K1"], n["K2"], n["K4"]) == (10, scans, scans)
    assert dtypes == {torch.float32}
    for name, calls in seen.items():
        f32 = (0, 1, 3, 4, 6) + ((8,) if name == "K4" else ())
        assert all(args[i].dtype == torch.float32
                   for args, _ in calls for i in f32), name
    (args, kw), (bargs, bkw) = seen["K2"][0], seen["K4"][0]
    want = k2.selective_scan_plain(*[None if t is None else t.float()
                                     for t in args], **kw)
    assert_close(k2.selective_scan_cuda(*args, **kw), want, 1e-5)
    wants = k2.selective_scan_bwd_plain(*[None if t is None else t.float()
                                          for t in bargs], **bkw)
    for got, want in zip(k2.selective_scan_bwd_cuda(*bargs, **bkw), wants):
        if want is not None:
            assert_close(got, want, 1e-4)


def test_stage1_steps_launch_the_kernels(cuda):
    """``GanTrainer`` over the canonical generator, ``PatchDiscriminator(3,
    32)`` and ``PerceptualLoss(0.25)`` in bf16, batch 1, ``adv_on=1``, a
    warm-up then three steps: each launches K1 10 times in the generator's
    forward (read when it returns) and 10 times as the input gradient
    after it, and K3 10 times, every K1 and K3 on its bf16 tensor-core
    variant; the losses finite, no step skipped; ``generate`` gives a
    finite PET of the MRI's shape."""
    trainer = stage1_trainer(cuda)
    gen = torch.Generator(device=cuda)
    at_forward_end = []
    trainer.generator.register_forward_hook(
        lambda *_: at_forward_end.append(k1.launches))
    stage1_step(trainer, gen.manual_seed(300))
    torch.cuda.synchronize()
    at_forward_end.clear()
    for i in range(3):
        before = launch_counts()
        logs = stage1_step(trainer, gen.manual_seed(i))
        n = launches_since(before)
        assert len(at_forward_end) == i + 1
        assert (at_forward_end[-1] - before["K1"], n["K1"], n["K1.mma"],
                n["K3"], n["K3.mma"]) == (10, 20, 20, 10, 10)
        assert all(math.isfinite(v) for v in logs.values())
        assert not logs["skipped"]
    gen.manual_seed(400)
    pet = trainer.generate(torch.randn(1, *IMG, 1, generator=gen,
                                       device=cuda))
    assert pet.shape == (1, *IMG, 1) and torch.isfinite(pet).all()


@pytest.mark.parametrize("spatial,C", GN_WIDTHS)
def test_group_norm_act_launches_once_per_call(cuda, spatial, C):
    """``group_norm_act`` forward and backward at a generator width,
    batch 4, bf16, elu (the 'cge' order's GroupNorm + ELU): one K5a and
    one K5b launch per call, the output finite and within 2^-6 of the
    two-pass ``_reference``, every gradient finite."""
    from gfe_mamba_torch.ops.group_norm import _reference, group_norm_act

    gen = torch.Generator(device=cuda).manual_seed(40)
    shape = (BATCH, *spatial, C)
    x = torch.randn(*shape, generator=gen, device=cuda).bfloat16()
    scale = torch.randn(C, generator=gen, device=cuda)
    bias = torch.randn(C, generator=gen, device=cuda)
    ins = [t.requires_grad_() for t in (x, scale, bias)]
    before = launch_counts()
    y = group_norm_act(*ins, num_groups=8, act="elu")
    y.backward(torch.randn(*shape, generator=gen, device=cuda).to(y.dtype))
    n = launches_since(before)
    assert (n["K5a"], n["K5b"]) == (1, 1)
    assert y.shape == shape
    assert all(torch.isfinite(t).all() for t in (y, *(i.grad for i in ins)))
    with torch.no_grad():
        assert_close(y, _reference(x, scale, bias, 8, 1e-5, "elu"),
                     2.0 ** -6)


def test_jamba2_mini_prefill_launches_the_long_kernel(cuda):
    """A stack of Jamba2-Mini's layout (8 layers: attention at 4, experts
    on the odd ones, 7 Mamba) at its Mamba widths (d_model 4096: ED 8192
    in v4's slabs of 64, chunks of 64), with a small MLP, experts and
    vocabulary, prefills a 4,467-token prompt in bf16: 7 K2 launches, all
    on the long kernel; a decode step launches none."""
    lm = jamba2_mini_stack(cuda)
    cfg = lm.config
    prompt = docqa_prompt(cuda)
    assert cfg.expand_factor * cfg.d_model == 8192
    assert k2.scan_plan(prompt.shape[1], cfg.d_state) == (64, 64)
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = launch_counts()
        logits, caches = lm.prefill(prompt, 1)
        n = launches_since(before)
        assert (n["K2"], n["K2.long"]) == (7, 7)
        before = launch_counts()
        lm.step(logits.argmax(-1), caches)
        assert launches_since(before)["K2.long"] == 0
