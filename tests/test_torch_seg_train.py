"""The port's segmentation losses, metrics, optimizers, plateau scheduler
and trainer step against the JAX package's, and its two segmentation
entry points end to end, on the CPU, f32.

Tolerances: losses and metrics 1e-5 relative to max(1, |JAX|) (the same
f32 reductions in other orders); each optimizer's parameters after 3
steps 1e-5 relative to max(1, max |JAX|) per tensor (torch's and optax's
updates are the same formulas, rounded in other orders); one
``UNetTrainer`` step against JAX's ``_train_step`` from the same weights:
the loss 1e-5 and the parameters 1e-4 relative (the gradients of two f32
UNets through Adam, whose first step moves each entry by lr x sign(g)).
The entry points are held to the JAX script's batch order, to their own
checkpoints and resume, and to ``sliding_window_predict`` of the best
checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfe_mamba_tpu.models import unet3d as jax_unet
from gfe_mamba_tpu.segmentation import losses as jax_losses
from gfe_mamba_tpu.segmentation import metrics as jax_metrics
from gfe_mamba_tpu.segmentation import trainer as jax_trainer
from gfe_mamba_torch.cli import seg_predict, seg_train
from gfe_mamba_torch.data import h5
from gfe_mamba_torch.models import unet3d
from gfe_mamba_torch.segmentation import losses, metrics, trainer
from gfe_mamba_torch.segmentation.predictor import sliding_window_predict
from gfe_mamba_torch.training.checkpoint import Checkpointer
from gfe_mamba_torch.utils.convert import (jax_variables_from_state_dict,
                                           state_dict_from_jax)

torch.set_num_threads(2)


def _close(got, want, rel, tag=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, (tag, err)


def _logits_and_targets():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 4, 3, 3).astype(np.float32)
    onehot = (rng.rand(2, 5, 4, 3, 3) > 0.6).astype(np.float32)
    labels = rng.randint(0, 3, (2, 5, 4, 3)).astype(np.int32)
    labels[0, 0, 0] = -1                        # an ignored voxel
    return logits, onehot, labels


_LOSSES = [
    ({"name": "DiceLoss"}, "onehot"),
    ({"name": "DiceLoss", "normalization": "softmax"}, "onehot"),
    ({"name": "GeneralizedDiceLoss"}, "onehot"),
    ({"name": "GeneralizedDiceLoss", "normalization": "none"}, "onehot1"),
    ({"name": "BCEDiceLoss", "alpha": 0.3, "beta": 0.7}, "onehot"),
    ({"name": "BCEWithLogitsLoss"}, "onehot"),
    ({"name": "CrossEntropyLoss"}, "labels"),
    ({"name": "CrossEntropyLoss", "ignore_index": -1}, "labels"),
    ({"name": "WeightedCrossEntropyLoss"}, "labels"),
    ({"name": "WeightedCrossEntropyLoss", "ignore_index": -1}, "labels"),
    ({"name": "MSELoss"}, "onehot"),
    ({"name": "L1Loss"}, "onehot"),
    ({"name": "SmoothL1Loss", "beta": 0.5}, "onehot"),
    ({"name": "WeightedSmoothL1Loss", "threshold": 0.5,
      "initial_weight": 3.0}, "onehot"),
    ({"name": "WeightedSmoothL1Loss", "threshold": 0.5,
      "initial_weight": 3.0, "apply_below_threshold": False}, "onehot"),
    ({"name": "DiceLoss", "ignore_index": 0}, "onehot"),
    ({"name": "MSELoss", "skip_last_target": True}, "onehot+1"),
]


@pytest.mark.parametrize("cfg,target", _LOSSES,
                         ids=[f"{c['name']}-{i}" for i, (c, _) in
                              enumerate(_LOSSES)])
def test_losses_match_jax(cfg, target):
    logits, onehot, labels = _logits_and_targets()
    t = {"onehot": onehot, "labels": labels, "onehot1": onehot[..., :1],
         "onehot+1": np.concatenate([onehot, onehot[..., :1]], -1)}[target]
    x = logits[..., :1] if target == "onehot1" else logits
    jfn = jax_losses.get_loss_criterion({"loss": dict(cfg)})
    pfn = losses.get_loss_criterion({"loss": dict(cfg)})
    want, jgrad = jax.value_and_grad(lambda z: jfn(z, jnp.asarray(t)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pfn(xt, torch.from_numpy(t))
    got.backward()
    _close(got, want, 1e-5, "loss")
    _close(xt.grad, jgrad, 1e-5, "grad")


def test_pixel_wise_cross_entropy_matches_jax():
    logits, _, labels = _logits_and_targets()
    labels = np.abs(labels)
    w = np.random.RandomState(1).rand(*labels.shape).astype(np.float32)
    want = jax_losses.pixel_wise_cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    got = losses.pixel_wise_cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(w))
    _close(got, want, 1e-5)


def _segmentations():
    rng = np.random.RandomState(2)
    gt = np.zeros((2, 12, 12, 4, 1), np.float32)
    gt[:, 1:5, 1:5], gt[:, 7:11, 6:10] = 1, 2
    gt[1, 7:11, 6:10] = 0
    probs = np.clip(gt / 2 + 0.3 * rng.rand(*gt.shape), 0, 1).astype(
        np.float32)
    return probs, gt


_METRICS = [
    {"name": "DiceCoefficient"}, {"name": "MeanIoU", "threshold": 0.4},
    {"name": "PSNR"}, {"name": "MSE"}, {"name": "AdaptedRandError"},
    {"name": "BoundaryAdaptedRandError", "thresholds": [0.3, 0.5]},
    {"name": "GenericAdaptedRandError", "input_channels": [0],
     "invert_channels": [0]},
    {"name": "BlobsAveragePrecision", "thresholds": [0.4, 0.6]},
    {"name": "BoundaryAveragePrecision"},
]


@pytest.mark.parametrize("cfg", _METRICS, ids=[c["name"] for c in _METRICS])
def test_metrics_match_jax(cfg):
    probs, gt = _segmentations()
    want = jax_metrics.get_evaluation_metric({"eval_metric": dict(cfg)})(
        jnp.asarray(probs), jnp.asarray(gt))
    got = metrics.get_evaluation_metric({"eval_metric": dict(cfg)})(
        torch.from_numpy(probs), torch.from_numpy(gt))
    _close(float(got), float(want), 1e-5, cfg["name"])


def test_instance_scores_match_jax():
    probs, gt = _segmentations()
    cfg = {"eval_metric": {"name": "InstanceScores", "iou_threshold": 0.3}}
    got = metrics.get_evaluation_metric(cfg)(torch.from_numpy(gt[0] > 0),
                                             gt[0])
    assert got == jax_metrics.get_evaluation_metric(cfg)(gt[0] > 0, gt[0])


_OPTIMIZERS = [
    {"name": "Adam", "learning_rate": 1e-2},
    {"name": "Adam", "learning_rate": 1e-2, "weight_decay": 0.1},
    {"name": "AdamW", "lr": 1e-2, "weight_decay": 0.05,
     "betas": [0.8, 0.99]},
    {"name": "SGD", "learning_rate": 0.1},
    {"name": "SGD", "learning_rate": 0.1, "nesterov": True,
     "momentum": 0.5},
    {"name": "RMSprop", "learning_rate": 1e-2},
    {"name": "Adagrad", "learning_rate": 0.1},
    {"name": "Adamax", "learning_rate": 1e-2},
]


@pytest.mark.parametrize("cfg", _OPTIMIZERS,
                         ids=[f"{c['name']}-{i}" for i, c in
                              enumerate(_OPTIMIZERS)])
def test_optimizers_match_optax(cfg):
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(4, 5).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = jax_trainer.create_optimizer(dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    port = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}
    opt = trainer.create_optimizer(dict(cfg), port.values())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in port.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        _close(port[k], jp[k], 1e-5, k)


def test_reduce_lr_on_plateau_matches_jax():
    scores = [0.5, 0.6, 0.6, 0.55, 0.58, 0.7, 0.7, 0.69, 0.1, 0.2, 0.3]
    for mode in ("max", "min"):
        a = trainer.ReduceLROnPlateau(mode, factor=0.3, patience=1)
        b = jax_trainer.ReduceLROnPlateau(mode, factor=0.3, patience=1)
        assert [a.step(s) for s in scores] == [b.step(s) for s in scores]


_STEP = [
    (dict(name="UNet3D", f_maps=8, num_levels=2, num_groups=2),
     (2, 8, 8, 8, 1), {"name": "BCEDiceLoss"}),
    (dict(name="UNet2D", f_maps=4, num_levels=2, num_groups=2,
          layer_order="cbr", out_channels=2, final_sigmoid=False),
     (2, 8, 8, 1), {"name": "DiceLoss", "normalization": "softmax"}),
]


@pytest.mark.parametrize("cfg,shape,loss", _STEP,
                         ids=[c["name"] for c, _, _ in _STEP])
def test_trainer_step_matches_jax(tmp_path, cfg, shape, loss):
    """From the same weights: loss, updated parameters, and the two
    reproduced quirks (``lr_scale`` scales the gradients; the BatchNorm
    statistics stay where they were)."""
    config = {"loss": loss, "eval_metric": {"name": "DiceCoefficient"},
              "optimizer": {"name": "Adam", "learning_rate": 1e-3}}
    port_model = unet3d.get_model(cfg, seed=4)
    tr = trainer.UNetTrainer(port_model, config, str(tmp_path / "p"),
                             device="cpu")
    tr.init_state(seed=4)
    order = cfg.get("layer_order", "gcr")
    with torch.no_grad():
        for name, b in port_model.named_buffers():
            b.copy_(torch.rand(b.shape) + 0.5)
    start = {k: v.clone() for k, v in port_model.state_dict().items()}
    variables = jax.tree_util.tree_map(
        jnp.asarray, jax_variables_from_state_dict(start, order))
    jmod = jax_unet.get_model({k: v for k, v in cfg.items()})
    jtr = jax_trainer.UNetTrainer(jmod, config, str(tmp_path / "j"))
    rng = np.random.RandomState(5)
    raw = rng.randn(*shape).astype(np.float32)
    label = (rng.rand(*shape[:-1], cfg.get("out_channels", 1)) > 0.5
             ).astype(np.float32)
    opt_state = jtr.base_tx.init(variables["params"])
    new, _, want_loss = jtr._train_step(
        variables, opt_state, 0.25, jnp.asarray(raw), jnp.asarray(label),
        jax.random.key(0))
    tr.lr_scale = 0.25
    got_loss = tr.train_step(torch.from_numpy(raw), torch.from_numpy(label))
    _close(got_loss, float(want_loss), 1e-5, "loss")
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new))
    got = port_model.state_dict()
    assert set(got) == set(want)
    moved = 0
    for key, value in want.items():
        _close(got[key], value, 1e-4, key)
        if key.endswith(("running_mean", "running_var")):
            assert torch.equal(got[key], start[key]), key
        else:
            moved += not torch.equal(got[key], start[key])
    assert moved == sum(1 for _ in port_model.parameters())


def _tree(root):
    rng = np.random.RandomState(6)
    for phase in ("train", "val", "test"):
        os.makedirs(os.path.join(root, phase))
        for i in range(2):
            raw = rng.rand(16, 16, 12).astype(np.float32)
            h5.write(os.path.join(root, phase, f"v{i}.h5"),
                     {"raw": raw, "label": (raw > 0.5).astype(np.uint8)})


def _config(root, **trainer_kw):
    trainer_cfg = dict(checkpoint_dir=f"{root}/ckpt", max_num_iterations=4,
                       max_num_epochs=5, validate_after_iters=2,
                       log_after_iters=1, **trainer_kw)
    lines = "\n".join(f"  {k}: {v}" for k, v in trainer_cfg.items())
    return f"""manual_seed: 3
model:
  name: UNet3D
  in_channels: 1
  out_channels: 1
  f_maps: 8
  num_levels: 2
  num_groups: 2
loss:
  name: BCEDiceLoss
eval_metric:
  name: DiceCoefficient
optimizer:
  name: Adam
  learning_rate: 1.0e-3
trainer:
{lines}
loaders:
  batch_size: 2
  train:
    file_paths: [{root}/train]
    slice_builder:
      patch_shape: [8, 8, 8]
      stride_shape: [8, 8, 4]
    transformer:
      - name: Standardize
      - name: RandomFlip
  val:
    file_paths:
      - {root}/val
    slice_builder:
      patch_shape: [8, 8, 8]
      stride_shape: [8, 8, 8]
  test:
    file_paths: [{root}/test]
    batch_size: 3
    slice_builder:
      patch_shape: [8, 8, 8]
      stride_shape: [4, 4, 4]
      halo_shape: [2, 2, 0]
model_path: {root}/ckpt/best_checkpoint
"""


def test_loaders_give_the_jax_scripts_batches(tmp_path):
    """The training loader's batches over two epochs are the JAX
    script's, its first epoch spent on the init sample as the script
    spends it.  Deterministic transforms only: a random one draws from
    each dataset's generator as items load, and the JAX script's sample
    batch loads a thread-timed number of batches ahead."""
    pytest.importorskip("h5py")
    yaml = pytest.importorskip("yaml")
    import seg_train as jax_script
    root = str(tmp_path)
    _tree(root)
    config = yaml.safe_load(_config(root))
    config["loaders"]["train"]["transformer"] = [{"name": "Standardize"}]
    port_train, port_val = seg_train.build_loaders(config)
    jax_train, jax_val = jax_script.build_loaders(config)
    port_train.epoch += 1
    next(iter(jax_train))
    for _ in range(2):
        for a, b in zip(port_train, jax_train, strict=True):
            np.testing.assert_array_equal(a["raw"], b["raw"])
            np.testing.assert_array_equal(a["label"], b["label"])
    for a, b in zip(port_val, jax_val, strict=True):
        np.testing.assert_array_equal(a["raw"], b["raw"])


def test_entry_points_train_resume_and_predict(tmp_path, capsys):
    root = str(tmp_path)
    _tree(root)
    path = tmp_path / "c.yaml"
    path.write_text(_config(root))
    args = ["--config", str(path), "--device", "cpu"]
    first = seg_train.main(seg_train.parse_args(args))
    assert first.num_iterations == 4
    assert sorted(os.listdir(f"{root}/ckpt")) == ["best_checkpoint",
                                                  "last_checkpoint"]
    last = Checkpointer(f"{root}/ckpt").restore("last_checkpoint")
    assert last["num_iterations"] == 4
    assert last["best_eval_score"] == first.best_eval_score
    for k, v in first.model.state_dict().items():
        assert torch.equal(last["model"][k], v), k
    resumed = seg_train.main(seg_train.parse_args(
        args + ["--override", "trainer.resume=true",
                "trainer.max_num_iterations=6"]))
    assert resumed.num_iterations == 6
    assert Checkpointer(f"{root}/ckpt").restore(
        "last_checkpoint")["num_iterations"] == 6
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()
            if line.startswith("iter")] == [f"iter {i}" for i in
                                            (1, 2, 3, 4, 5, 6)]

    written = seg_predict.main(seg_train.parse_args(args))
    assert written == [f"{root}/test/v0_predictions.h5",
                       f"{root}/test/v1_predictions.h5"]
    best = Checkpointer(f"{root}/ckpt").restore("best_checkpoint")
    model = unet3d.get_model(dict(name="UNet3D", f_maps=8, num_levels=2,
                                  num_groups=2))
    model.load_state_dict(best["model"])
    for src, dst in zip(("v0.h5", "v1.h5"), written):
        raw = h5.read(os.path.join(root, "test", src), "raw")

        def fwd(x):
            with torch.no_grad():
                return model(torch.from_numpy(x)).numpy()
        want = sliding_window_predict(fwd, raw, (8, 8, 8), (4, 4, 4),
                                      halo_shape=(2, 2, 0), batch_size=3)
        got = h5.read(dst, "predictions")
        assert got.shape == (1, 16, 16, 12)
        np.testing.assert_array_equal(got, np.moveaxis(want, -1, 0))
        assert 0.0 <= got.min() and got.max() <= 1.0
