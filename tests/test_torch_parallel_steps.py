"""Data-, tensor- and expert-parallel training of the port on two gloo
ranks on the CPU, against the JAX package on one device.

One launch of two ranks (``parallel/dryrun.py::launch``, workers in
``gfe_mamba_torch/testing.py``) takes, each rank on its rows of a global
batch: a Stage-2 step (Mamba head), a Stage-2 step whose global batch
holds a NaN in rank 1's rows, and Stage-1 G + D steps with the warm-up
gate off and on.  A second launch splits the tiny Jamba pipeline of the
dry run over a model axis of 2 (threshold 128: ViT, cross-attention,
Mamba in_proj and feed-forward kernels, MoE experts), loading JAX's
tree shard by shard, takes its forward and gradients, and gathers its
weights back into one tree (bitwise the tree loaded).  Meanwhile this process computes JAX's steps on
the whole global batch from the same weights (drawn by the port,
carried across with ``utils/convert.py``).  Dropout is off on both sides
(the two frameworks draw different bits); with it on, the two ranks are
held instead to this process stepping the global batch.

Tolerances: those of ``tests/test_torch_train_stage2.py`` (loss 1e-5
relative; Adam's first moment, 0.1 x the clipped gradient, within 1e-4
of each tensor's largest JAX entry; updated parameters within 1e-6 x
max(1, |p|) where the gradient is over 1e-6, else within 2 lr) and of
``tests/test_torch_train_stage1.py`` (the five losses 1e-4 relative;
first moments within 1e-3 of each tensor's largest JAX entry), and
f32 1e-4 for the split forward and gradients (relative to each tensor's
largest JAX entry).  Across ranks the parameters are bitwise equal.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfe_mamba_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from gfe_mamba_tpu.models.combiners import CombineClassifierVitMid as JaxComb
from gfe_mamba_tpu.models.discriminator import \
    PatchDiscriminator as JaxPatchDiscriminator
from gfe_mamba_tpu.models.fusion import CrossMambaBoth as JaxCrossMambaBoth
from gfe_mamba_tpu.models.pipeline import GFEMamba as JaxGFEMamba
from gfe_mamba_tpu.models.pipeline import build_gfe_mamba as jax_build
from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT as JaxGen
from gfe_mamba_tpu.training.classify_trainer import ClassifyState
from gfe_mamba_tpu.training.classify_trainer import \
    ClassifyTrainer as JaxClassifyTrainer
from gfe_mamba_tpu.training.gan_trainer import GanState
from gfe_mamba_tpu.training.gan_trainer import GanTrainer as JaxGanTrainer
from gfe_mamba_torch import testing
from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.pipeline import build_generator, build_gfe_mamba
from gfe_mamba_torch.parallel.dryrun import TINY_PIPELINE, launch
from gfe_mamba_torch.utils.convert import (jax_tree_from_state_dict,
                                           state_dict_from_jax)

IMG = (16, 16, 8)
LR = 1e-4
GEN = dict(f_maps=(4, 8), layer_order="gcr", fold_factor=2,
           vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
           vit_mlp_dim=32, vit_dropout=0.0, vit_emb_dropout=0.0)
CLS = dict(categories=(3, 5, 2), num_continuous=4, dim=16, depth=1, heads=2)
TIMEOUT = 240


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _stage2_batches():
    rng = np.random.RandomState(0)
    batch = dict(mri=rng.randn(4, *IMG, 1).astype(np.float32),
                 x_cat=rng.randint(0, 2, (4, 3)).astype(np.int32),
                 x_num=rng.randn(4, 4).astype(np.float32),
                 labels=np.asarray([1.0, 0.0, 0.0, 1.0], np.float32))
    nan = {k: v.copy() for k, v in batch.items()}
    nan["x_num"][3, 0] = np.nan                  # one of rank 1's rows
    return batch, nan


def _stage1_batch():
    rng = np.random.RandomState(1)
    return dict(mri=rng.randn(2, *IMG, 1).astype(np.float32),
                pet=rng.randn(2, *IMG, 1).astype(np.float32))


def _jamba_inputs():
    rng = np.random.RandomState(3)
    return ([rng.randn(2, *IMG, 1).astype(np.float32),
             rng.randint(0, 2, (2, 3)).astype(np.int32),
             rng.randn(2, 4).astype(np.float32)],
            np.asarray([1.0, 0.0], np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two launches (in a thread) and JAX's references (here)."""
    out = str(tmp_path_factory.mktemp("ranks"))
    s2_build = dict(img_size=IMG, seq_length=2, cross_ff_dropout=0.0,
                    seed=0, **GEN, **CLS)
    s2_tree = jax_tree_from_state_dict(
        build_gfe_mamba(device="cpu", **s2_build).state_dict())
    g_tree = jax_tree_from_state_dict(
        build_generator(device="cpu", img_size=IMG, seed=2, **GEN)
        .state_dict())
    disc = PatchDiscriminator(2, 4)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    d_tree = jax_tree_from_state_dict(disc.state_dict())
    # the port's perceptual trunk (seed 0), handed to JAX as a weights
    # file, which also spares JAX an init
    squeeze = str(tmp_path_factory.mktemp("squeeze") / "squeeze.npz")
    np.savez(squeeze, params=np.asarray({"params": jax_tree_from_state_dict(
        PerceptualLoss(0.5, device="cpu").net.state_dict())}, dtype=object))
    perceptual = JaxPerceptual(fake_3d_ratio=0.5, weights_path=squeeze)
    tp_build = dict(img_size=IMG, seed=0, **TINY_PIPELINE)
    tp_tree = jax_tree_from_state_dict(
        build_gfe_mamba(device="cpu", **tp_build).state_dict(), "cge")
    batch, nan = _stage2_batches()
    gan = _stage1_batch()
    s2 = dict(stage=2, build=s2_build, jax=s2_tree, keys=(
        "mri", "x_cat", "x_num", "labels"), jax_keys=True,
        trainer=dict(lr=LR, mixed_precision="none"))
    s1 = dict(stage=1, build=dict(img_size=IMG, seed=2, **GEN), disc=(2, 4),
              fake_3d_ratio=0.5, jax=dict(g=g_tree, d=d_tree),
              keys=("mri", "pet"), jax_keys=True,
              trainer=dict(mixed_precision="none", g_init="torch"),
              batches=[gan])
    # dropout on (the masks of one process over the global batch):
    # Stage 2's final feed-forward, Stage 1's ViT
    dropout = [
        dict(s2, name="stage2_dropout", batches=[batch], jax_keys=False,
             build=dict(s2_build, cross_ff_dropout=0.5)),
        dict(s1, name="stage1_dropout", extra=(1.0,), jax_keys=False,
             build=dict(s1["build"], vit_dropout=0.3, vit_emb_dropout=0.3))]
    spec = dict(device="cpu", jobs=[
        dict(s2, name="stage2", batches=[batch]),
        dict(s2, name="nan", batches=[nan], keep=False),
        dict(s1, name="gate_off", extra=(0.0,)),
        dict(s1, name="gate_on", extra=(1.0,)), *dropout])
    inputs, labels = _jamba_inputs()
    tp = dict(build=tp_build, jax=tp_tree, threshold=128, inputs=inputs,
              labels=labels)
    errors = []

    def ranks():
        try:
            launch(testing.dp_steps, 2, (out, spec), timeout_s=TIMEOUT)
            launch(testing.tp_forward_and_grads, 2, (out, tp),
                   timeout_s=TIMEOUT)
        except BaseException as exc:         # re-raised below
            errors.append(exc)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = dict(stage2=_jax_stage2(s2_tree, batch),
                   stage1=_jax_stage1(g_tree, d_tree, perceptual, gan),
                   tp=_jax_tp(tp_tree, inputs, labels),
                   one={job["name"]: testing.run_job(
                       job, None, torch.device("cpu")) for job in dropout})
    finally:
        thread.join(TIMEOUT * 2 + 30)
    assert not thread.is_alive(), "the ranks did not finish"
    if errors:
        raise errors[0]
    ranks_out = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    return dict(ref=ref, ranks=ranks_out, s2_tree=s2_tree, tp_tree=tp_tree,
                tp=torch.load(os.path.join(out, "tp.pt"),
                              weights_only=False))


def _jax_stage2(tree, batch):
    pipeline = JaxGFEMamba(
        generator=JaxGen(1, 1, is_segmentation=False, **GEN),
        combiner=JaxComb(seq_length=2),
        classifier=JaxCrossMambaBoth(dim_head=8, cross_ff_dropout=0.0,
                                     **CLS))
    trainer = JaxClassifyTrainer(pipeline, lr=LR, mixed_precision="none")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    state = ClassifyState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=trainer.tx.init(params["params"]))
    new, logs = trainer.train_step(
        state, *(jnp.asarray(batch[k]) for k in
                 ("mri", "x_cat", "x_num", "labels")), jax.random.key(1))
    adam = new.opt_state.inner_states["train"].inner_state[1][0]
    return dict(loss=float(logs["cla_loss"]), acc=float(logs["batch_acc"]),
                params=_np(new.params["params"]),
                mu=_np({k: v for k, v in adam.mu.items()
                        if k != "generator"}))


def _jax_stage1(g_tree, d_tree, perceptual, batch):
    trainer = JaxGanTrainer(
        JaxGen(1, 1, is_segmentation=False, **GEN),
        JaxPatchDiscriminator(num_layers_d=2, num_channels=4), perceptual,
        mixed_precision="none", g_init="flax")
    out = {}
    for adv_on in (0.0, 1.0):
        gp = {"params": jax.tree_util.tree_map(jnp.asarray, g_tree)}
        dp = {"params": jax.tree_util.tree_map(jnp.asarray, d_tree)}
        state = GanState(step=jnp.zeros((), jnp.int32), g_params=gp,
                         d_params=dp, g_opt=trainer.g_tx.init(gp["params"]),
                         d_opt=trainer.d_tx.init(dp["params"]))
        new, logs = trainer.train_step(
            state, jnp.asarray(batch["mri"]), jnp.asarray(batch["pet"]),
            jnp.float32(adv_on), jax.random.key(2))
        out[adv_on] = dict(logs={k: float(v) for k, v in logs.items()},
                           g_mu=_np(new.g_opt[1][0].mu),
                           d_mu=_np(new.d_opt[0].mu))
    return out


def _jax_tp(tree, inputs, labels):
    pipeline = jax_build(**{k: v for k, v in TINY_PIPELINE.items()
                            if k != "cross_ff_dropout"})
    args = [jnp.asarray(a) for a in inputs]

    def loss(p):
        logits = pipeline.apply({"params": p}, *args).squeeze(-1)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(labels))), logits

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return dict(loss=float(value), logits=np.asarray(logits),
                grads=_np(grads))


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-9, (name, err)


def _flat(tree, prefix=""):
    from gfe_mamba_torch.utils.convert import flatten_tree
    return flatten_tree(tree, prefix)


def test_dp_stage2_step_equals_jax_on_the_global_batch(runs):
    ref = runs["ref"]["stage2"]
    for rank in runs["ranks"]:
        job = rank["stage2"]
        logs = job["logs"][0]
        np.testing.assert_allclose(logs["cla_loss"], ref["loss"], rtol=1e-5)
        assert logs["batch_acc"] == ref["acc"] and logs["skipped"] == 0.0
        mu = state_dict_from_jax(ref["mu"])
        for name, value in job["moments"]["model"].items():
            _close(value, mu[name], 1e-4, name)
        got = _flat(job["params"]["model"])
        want, before = _flat(ref["params"]), _flat(runs["s2_tree"])
        mu_flat = _flat(ref["mu"])
        for key, value in got.items():
            if key.startswith("generator/"):
                np.testing.assert_array_equal(value, before[key])
                continue
            diff = np.abs(value - want[key])
            assert np.all(diff <= 2.0001 * LR), key
            tiny = np.abs(mu_flat[key]) <= 1e-7
            np.testing.assert_array_less(
                diff[~tiny], 1e-6 * np.maximum(1.0, np.abs(want[key])[~tiny])
                + 1e-12)
    a, b = (r["stage2"]["digests"] for r in runs["ranks"])
    assert a == b


def test_nan_in_one_ranks_rows_skips_the_step_on_both(runs):
    """Rank 1's rows hold the NaN: both ranks skip, Adam's count advances
    on both, and no parameter moves (bitwise the weights loaded, bitwise
    equal across ranks)."""
    a, b = (r["nan"] for r in runs["ranks"])
    for job in (a, b):
        assert job["logs"][0]["skipped"] == 1.0
        assert np.isnan(job["logs"][0]["cla_loss"])
        assert job["adam_counts"]["model"] == [1]
    assert a["digests"] == b["digests"]
    start = {f"model.{k}": testing.tensor_digest(v) for k, v in
             state_dict_from_jax(runs["s2_tree"]).items()}
    assert {k: a["digests"][k] for k in start} == start


@pytest.mark.parametrize("gate", ["gate_off", "gate_on"])
def test_dp_stage1_step_equals_jax_on_the_global_batch(runs, gate):
    ref = runs["ref"]["stage1"][0.0 if gate == "gate_off" else 1.0]
    for rank in runs["ranks"]:
        job = rank[gate]
        logs = job["logs"][0]
        assert logs["skipped"] == 0.0
        for key in ("g_loss", "d_loss", "l1", "perceptual", "gen_adv"):
            np.testing.assert_allclose(logs[key], ref["logs"][key],
                                       rtol=1e-4, atol=1e-9, err_msg=key)
        for player, mu in (("generator", ref["g_mu"]),
                           ("discriminator", ref["d_mu"])):
            moments = job["moments"][player]
            if gate == "gate_off" and player == "discriminator":
                assert not moments          # D does not move in warm-up
                continue
            mu = state_dict_from_jax(mu)
            assert set(moments) == set(mu)
            for name, value in moments.items():
                _close(value, mu[name], 1e-3, f"{player}.{name}")
    a, b = (r[gate]["digests"] for r in runs["ranks"])
    assert a == b


@pytest.mark.parametrize("name,off,losses,rel", [
    ("stage2_dropout", "stage2", ("cla_loss",), 1e-4),
    ("stage1_dropout", "gate_on", ("g_loss", "d_loss", "l1"), 1e-3)])
def test_dropout_masks_are_one_process_global_batch_masks(runs, name, off,
                                                          losses, rel):
    """Dropout on: each rank keeps its rows of the global batch's masks,
    so both ranks step as one process stepping the global batch (losses
    1e-5 relative; first moments, 0.1 x the averaged (clipped) gradient,
    to the tolerances of the tests above); the masks did drop (the
    losses are not the dropout-off step's)."""
    one = runs["ref"]["one"][name]
    for rank in runs["ranks"]:
        job = rank[name]
        for key in losses:
            np.testing.assert_allclose(job["logs"][0][key],
                                       one["logs"][0][key], rtol=1e-5,
                                       err_msg=key)
        for player, moments in job["moments"].items():
            assert set(moments) == set(one["moments"][player])
            for k, value in moments.items():
                _close(value.numpy(), one["moments"][player][k].numpy(), rel,
                       f"{player}.{k}")
    loss = losses[0]
    dropped = one["logs"][0][loss]
    plain = runs["ranks"][0][off]["logs"][0][loss]
    assert abs(dropped - plain) > 1e-3 * abs(plain)
    a, b = (r[name]["digests"] for r in runs["ranks"])
    assert a == b


def test_tp_ep_forward_and_gradient_equal_jax_replicated(runs):
    got, ref = runs["tp"], runs["ref"]["tp"]
    assert len(got["split"]) == 12
    # the whole flax tree went in shard by shard and comes back whole
    loaded, back = _flat(runs["tp_tree"]), _flat(got["weights"])
    assert set(back) == set(loaded)
    for key, value in loaded.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    _close(got["logits"].numpy(), ref["logits"], 1e-4, "logits")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = {k: v for k, v in _flat(ref["grads"]).items()
            if not k.startswith("generator/")}   # frozen in the port
    have = _flat(got["grads"])
    assert set(have) == set(want)
    for key, value in want.items():
        _close(have[key], value, 1e-4, key)
