"""The segmentation family on the card, f32 with TF32 off: each family
against the CPU, a UNet3D training step against the CPU and a witness,
K1 and K3 at the segmentation widths and at UNet3D's 13 conv shapes,
``seg_predict`` and ``seg_train``.  Every test needs an NVIDIA GPU
(``cuda`` marker) and skips without one; the file imports torch and the
port only::

    python -m pytest --noconftest -m cuda tests/test_torch_seg_cuda.py -q
"""

import copy
import math
import os

import numpy as np
import pytest
import torch

from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.testing import UNET3D_PATCH as PATCH
from gfe_mamba_torch.testing import (UNET3D, assert_close, assert_logs_close,
                                     moment_errors, plain_convs_on_card,
                                     worst_errors)

pytestmark = pytest.mark.cuda

# both families at full width, UNet2D (cuDNN only) and the SE family at a
# small width; K1 launches per forward (UNet3D's C_in = 1 stem on cuDNN)
FAMILIES = {
    "UNet3D": (UNET3D, (1, 32, 64, 64, 1), 13),
    "ResidualUNet3D": (dict(name="ResidualUNet3D", in_channels=1,
                            out_channels=1), (1, 32, 64, 64, 1), 18),
    "UNet2D": (dict(name="UNet2D", in_channels=1, out_channels=3, f_maps=16,
                    final_sigmoid=False), (2, 128, 128, 1), 0),
    "ResidualUNetSE3D": (dict(name="ResidualUNetSE3D", in_channels=2,
                              out_channels=2, f_maps=16, num_levels=4),
                         (1, 32, 32, 32, 2), None)}
VOLUME, STRIDE, PREDICT_BATCH = (96, 192, 192), (32, 64, 64), 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg, seed=0):
    from gfe_mamba_torch.models.unet3d import get_model
    return get_model(cfg, seed=seed)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_the_cpu(cuda, family):
    """Each family's logits on the card against the CPU, same weights,
    within 1e-4; UNet3D and ResidualUNet3D at full width launch K1 13 and
    18 times per forward, UNet2D never."""
    cfg, shape, launches = FAMILIES[family]
    model = _model(dict(cfg, is_segmentation=False), seed=5)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = model(x)
        model.to(cuda)
        before = k1.launches
        got = model(x.to(cuda))
        torch.cuda.synchronize()
    assert_close(got, want, 1e-4)
    if launches is not None:
        assert k1.launches - before == launches


def test_unet3d_step_matches_the_cpu_and_the_witness(cuda, tmp_path):
    """One ``UNetTrainer`` step (BCEDice, Adam) of UNet3D at full width on
    a 32x64x64 patch, from the same weights, on the CPU, on the card (K1,
    K1-dz, K3) and on the card with the plain convs (the witness).  Every
    derivative is continuous (order gce, the encoders pooling by average:
    relu's masks and max pooling's argmax flip on rounding), so the
    kernels' step holds to the witness within 1e-4 (the loss, each
    gradient against its largest entry and its norm) and to the CPU: the
    loss within 1e-4, the gradients within twice the witness's worst
    distance (at least 1e-3)."""
    from gfe_mamba_torch.ops.blocks import Encoder
    from gfe_mamba_torch.segmentation.trainer import UNetTrainer

    config = {"loss": {"name": "BCEDiceLoss"},
              "eval_metric": {"name": "DiceCoefficient"},
              "optimizer": {"name": "Adam", "learning_rate": 1e-4}}
    gen = torch.Generator().manual_seed(16)
    raw = torch.randn(1, 32, 64, 64, 1, generator=gen)
    label = (torch.rand(raw.shape, generator=gen) > 0.5).float()
    model = _model(dict(UNET3D, layer_order="gce"), seed=17)
    for module in model.modules():
        if isinstance(module, Encoder):
            module.pool_type = "avg"
    trainers, logs = [], []
    for device, m, witness in (("cpu", model, False),
                               (cuda, copy.deepcopy(model), False),
                               (cuda, copy.deepcopy(model), True)):
        tr = UNetTrainer(m, config, str(tmp_path), device=device)
        tr.init_state(0)
        if witness:
            with plain_convs_on_card():
                loss = tr.train_step(raw.to(tr.device), label.to(tr.device))
        else:
            loss = tr.train_step(raw.to(tr.device), label.to(tr.device))
        logs.append({"loss": loss})
        trainers.append(tr)
    torch.cuda.synchronize()

    def errors(a, b):
        return moment_errors([("U", a.optimizer,
                               dict(a.model.named_parameters()), b.optimizer,
                               dict(b.model.named_parameters()))])

    on_cpu, kernels, witness = trainers
    assert_logs_close(logs[2], logs[1], 1e-4)
    against_witness = errors(witness, kernels)
    assert against_witness
    assert max(worst_errors(against_witness)) <= 1e-4
    assert_logs_close(logs[0], logs[1], 1e-4)
    plain = worst_errors(errors(on_cpu, witness))
    got = worst_errors(errors(on_cpu, kernels))
    assert got[0] <= max(1e-3, 2 * plain[0]), (got, plain)
    assert got[1] <= max(1e-3, 2 * plain[1]), (got, plain)


def _conv_inputs(gen, shape, C, F, device):
    x = torch.randn(*shape, C, generator=gen, device=device)
    w = torch.randn(3, 3, 3, C, F, generator=gen, device=device) \
        * (27 * C) ** -0.5
    a = torch.rand(shape[0], C, generator=gen, device=device) + 0.5
    s = torch.randn(shape[0], C, generator=gen, device=device)
    g1 = torch.randn(*shape, F, generator=gen, device=device)
    return x, w, a, s, g1


def _kernels_against_plain(x, w, a, s, g1):
    """K1 (the folded GN and relu), K1 as dz (the cotangent through the
    flipped, transposed weights) and K3 (with the GN affine) against
    their plain versions, f32, 1e-4 of max(1, max |plain|)."""
    wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    for name, got, want in (
            ("K1", k1.conv3x3x3_cuda(x, w, None, a, s, None, "relu"),
             k1.conv3x3x3_plain(x, w, None, a, s, None, "relu")),
            ("K1-dz", k1.conv3x3x3_cuda(g1, wf), k1.conv3x3x3_plain(g1, wf)),
            ("K3", k1.conv3x3x3_dw_cuda(x, g1, a, s),
             k1.conv3x3x3_dw_plain(x, g1, a, s))):
        torch.cuda.synchronize()
        assert_close(got, want, 1e-4, name=name)


@pytest.mark.parametrize("C,F", [(32, 64), (192, 64), (384, 128),
                                 (768, 256)])
def test_kernels_at_the_segmentation_widths(cuda, C, F):
    """DoubleConv's 32 -> 64 and the decoders' concat-joined 192, 384 and
    768 inputs, on a (1, 12, 20, 24) volume."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    _kernels_against_plain(*_conv_inputs(gen, (1, 12, 20, 24), C, F, cuda))


def test_kernels_at_the_unet3d_shapes(cuda):
    """UNet3D's forward on one 64x128x128 patch runs 13 K1 convs (the
    shapes ``chip_smoke.py`` times); at each of them K1, K1-dz and K3
    hold to their plain versions."""
    from gfe_mamba_torch.ops.blocks import SingleConv

    model = _model(UNET3D).to(cuda)
    specs, hooks = [], []
    for mod in model.modules():
        if isinstance(mod, SingleConv) and mod.fused:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: specs.append(
                    (tuple(args[0].shape), m.conv.weight.shape[0]))))
    with torch.no_grad():
        model(torch.randn(1, *PATCH, 1, device=cuda))
    for h in hooks:
        h.remove()
    del model
    assert len(specs) == 13
    gen = torch.Generator(device=cuda).manual_seed(15)
    for shape, F in specs:
        _kernels_against_plain(*_conv_inputs(gen, shape[:-1], shape[-1], F,
                                             cuda))


def test_the_stem_goes_to_cudnn(cuda):
    """The stem's C_in = 1 is refused by K1 and ruled onto cuDNN."""
    from gfe_mamba_torch.ops.blocks import SingleConv, k1_eligible

    with pytest.raises(ValueError):
        k1.conv3x3x3_cuda(torch.randn(1, 8, 8, 8, 1, device=cuda),
                          torch.randn(3, 3, 3, 1, 32, device=cuda))
    assert not k1_eligible(3, 3, 1, 1, 32)
    assert not SingleConv(1, 32, "gcr", 8).fused


def _write_volume(path, shape, seed):
    """A smooth synthetic volume and its foreground label, written by
    ``data/h5.py`` (gzip-chunked)."""
    from gfe_mamba_torch.data import h5

    rng = np.random.RandomState(seed)
    coarse = rng.randn(*[max(2, n // 16) for n in shape]).astype(np.float32)
    raw = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=tuple(shape),
        mode="trilinear", align_corners=False)[0, 0].numpy()
    raw += 0.1 * rng.randn(*shape).astype(np.float32)
    h5.write(path, {"raw": raw, "label": (raw > 0).astype(np.uint8)})


def _seg_config(root, name="seg", test=None, model_path=None):
    """The nested YAML of a segmentation run over ``root``'s directories;
    the CLIs' argument namespace for it."""
    import argparse

    model = "\n".join(f"  {k}: {v}" for k, v in UNET3D.items())
    text = f"""manual_seed: 0
model:
{model}
model_path: {model_path or root + '/ckpt/best_checkpoint'}
loss:
  name: BCEDiceLoss
eval_metric:
  name: DiceCoefficient
optimizer:
  name: Adam
  learning_rate: 1.0e-4
trainer:
  checkpoint_dir: {root}/ckpt
  max_num_iterations: 3
  max_num_epochs: 10
  validate_after_iters: 2
  log_after_iters: 1
loaders:
  batch_size: 1
  num_workers: 0
  train:
    file_paths: [{root}/train]
    slice_builder:
      patch_shape: {list(PATCH)}
      stride_shape: {list(PATCH)}
    transformer:
      - name: Standardize
  val:
    file_paths: [{root}/val]
    slice_builder:
      patch_shape: {list(PATCH)}
      stride_shape: {list(PATCH)}
  test:
    file_paths: [{test or root + '/test'}]
    batch_size: {PREDICT_BATCH}
    slice_builder:
      patch_shape: {list(PATCH)}
      stride_shape: {list(STRIDE)}
"""
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)

    def args(*overrides):
        return argparse.Namespace(config=path, override=list(overrides),
                                  device="cuda")
    return args


def test_seg_predict(cuda, tmp_path):
    """``seg_predict`` over a 96x192x192 volume (8 patches at batch 4)
    from a checkpoint of seeded weights: the file read back by
    ``data/h5.py`` equals ``sliding_window_predict`` driven directly
    (1e-6), and K1 launches 13 times per forward."""
    from gfe_mamba_torch.cli import seg_predict
    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.segmentation.predictor import sliding_window_predict
    from gfe_mamba_torch.segmentation.slicers import SliceBuilder
    from gfe_mamba_torch.training.checkpoint import Checkpointer

    root = str(tmp_path)
    os.makedirs(f"{root}/big")
    _write_volume(f"{root}/big/volume.h5", VOLUME, 11)
    model = _model(UNET3D, seed=12)
    Checkpointer(f"{root}/seeded").save("weights", {
        "model": model.state_dict(), "num_iterations": 0,
        "best_eval_score": 0.0})
    args = _seg_config(root, name="predict", test=f"{root}/big",
                       model_path=f"{root}/seeded/weights")
    before = k1.launches
    written = seg_predict.main(args())
    torch.cuda.synchronize()
    launches = k1.launches - before
    forwards = -(-len(SliceBuilder(VOLUME, PATCH, STRIDE)) // PREDICT_BATCH)
    got = h5.read(written[0], "predictions")
    model.to(cuda)

    @torch.no_grad()
    def forward(x):
        return model(torch.from_numpy(x).to(cuda)).cpu().numpy()

    raw = h5.read(f"{root}/big/volume.h5", "raw")[..., None]
    want = np.moveaxis(sliding_window_predict(
        forward, raw, PATCH, STRIDE, batch_size=PREDICT_BATCH), -1, 0)
    assert got.shape == (1, *VOLUME) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-6
    assert launches == 13 * forwards


def test_seg_train(cuda, tmp_path):
    """``seg_train`` of UNet3D at full width, batch 1: 3 steps with one
    validation and both checkpoints, a resume from the last one to step
    4, then ``seg_predict`` from the best one (finite, in [0, 1]).  Each
    step launches K1 13 times in the forward and 13 times as dz, and K3
    13 times, on its f32 variant."""
    from gfe_mamba_torch.cli import seg_predict, seg_train
    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.segmentation import trainer as seg_trainer
    from gfe_mamba_torch.training.checkpoint import Checkpointer

    root = str(tmp_path)
    for phase, shape, seed in (("train", (PATCH[0], PATCH[1], 2 * PATCH[2]),
                                21), ("val", PATCH, 22), ("test", PATCH, 23)):
        os.makedirs(f"{root}/{phase}")
        _write_volume(f"{root}/{phase}/v.h5", shape, seed)
    args = _seg_config(root)
    steps = []
    original = seg_trainer.UNetTrainer.train_step

    def counted(self, raw, label):
        at_forward_end = []
        hook = self.model.register_forward_hook(
            lambda *_: at_forward_end.append(k1.launches))
        before = (k1.launches, k1.dw_launches, k1.dw_fma_launches)
        try:
            loss = original(self, raw, label)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        steps.append((at_forward_end[0] - before[0],
                      k1.launches - at_forward_end[0],
                      k1.dw_launches - before[1],
                      k1.dw_fma_launches - before[2], math.isfinite(loss)))
        return loss

    seg_trainer.UNetTrainer.train_step = counted
    try:
        first = seg_train.main(args())
        resumed = seg_train.main(args("trainer.resume=true",
                                      "trainer.max_num_iterations=4"))
    finally:
        seg_trainer.UNetTrainer.train_step = original
    assert steps == [(13, 13, 13, 13, True)] * 5
    ckpt = Checkpointer(f"{root}/ckpt")
    last = ckpt.restore("last_checkpoint", map_location="cpu")
    assert (first.num_iterations, resumed.num_iterations,
            last["num_iterations"]) == (3, 4, 4)
    assert ckpt.exists("best_checkpoint")
    pred = h5.read(seg_predict.main(args())[0], "predictions")
    assert pred.shape == (1, *PATCH) and np.isfinite(pred).all()
    assert pred.min() >= 0 and pred.max() <= 1
