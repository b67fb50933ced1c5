"""One Stage-2 classifier step of the port (``ClassifyTrainer``) against
the JAX package's, from the same weights (carried by
``state_dict_from_jax``) and the same numpy batch, f32 on the CPU; plus
the frozen generator, the finite guard, the metrics and the clips.

The JAX pipeline is built with ``CrossMambaBoth(cross_ff_dropout=0.0)``
so that no dropout mask enters either side.  After one step, Adam's
first moment is 0.1 x the clipped gradient on both sides (optax ``mu``,
torch ``exp_avg``), so it stands in for the gradient.

Tolerances: loss 1e-5 relative; gradients within 1e-4 of each tensor's
largest JAX entry (f32 sums in other orders through the Mamba scan and
the 64-wide cross-attention).  Updated parameters: Adam's first step
moves each entry by lr * g / (|g| + 1e-8), about lr * sign(g), so
entries whose gradient is below 1e-6 may differ by up to 2 lr (a sign
decided by rounding); all others agree within 1e-6 * max(1, |p|).  The
same holds for the finite step after a skipped one, whose update is
Adam's at count 2 on both sides (about 0.74 lr * sign(g)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfe_mamba_tpu.models.combiners import CombineClassifierVitMid as JaxComb
from gfe_mamba_tpu.models.fusion import CrossMambaBoth as JaxCrossMambaBoth
from gfe_mamba_tpu.models.pipeline import GFEMamba as JaxGFEMamba
from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT as JaxGen
from gfe_mamba_tpu.training import metrics as jax_metrics
from gfe_mamba_tpu.training.classify_trainer import ClassifyState
from gfe_mamba_tpu.training.classify_trainer import \
    ClassifyTrainer as JaxClassifyTrainer
from gfe_mamba_tpu.training.optim import clip_by_param_norm
from gfe_mamba_torch.models.pipeline import build_gfe_mamba
from gfe_mamba_torch.training import metrics, optim
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

IMG = (16, 16, 8)
LR = 1e-4
GEN = dict(f_maps=(8, 16, 32), layer_order="gcr", fold_factor=2,
           vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
           vit_mlp_dim=32)
CLS = dict(categories=(3, 5, 2), num_continuous=4, dim=64, depth=1, heads=2)


def _assert_close(got, want, name="", rel=1e-4):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-9, (name, err)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, *IMG, 1).astype(np.float32),
            rng.randint(0, 2, (2, 3)).astype(np.int32),
            rng.randn(2, 4).astype(np.float32),
            np.asarray([1.0, 0.0], np.float32))


def _port_model(params):
    model = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2,
                            cross_ff_dropout=0.0, **GEN, **CLS)
    model.load_state_dict(state_dict_from_jax(params))
    return model


@pytest.fixture(scope="module")
def reference():
    """One JAX init, train step and eval step, shared by the tests."""
    generator = JaxGen(1, 1, is_segmentation=False, **GEN)
    pipeline = JaxGFEMamba(
        generator=generator, combiner=JaxComb(seq_length=2),
        classifier=JaxCrossMambaBoth(dim_head=32, cross_ff_dropout=0.0,
                                     **CLS))
    trainer = JaxClassifyTrainer(pipeline, lr=LR, mixed_precision="none")
    batch = _batch()
    jb = [jnp.asarray(v) for v in batch]
    params = jax.jit(pipeline.init)(jax.random.key(0), *jb[:3])
    params0 = jax.tree_util.tree_map(np.array, params)
    state = ClassifyState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=trainer.tx.init(params["params"]))
    probs, eval_loss, counts = trainer.eval_step(params, *jb)
    probs, eval_loss = np.asarray(probs), float(eval_loss)
    counts = [float(c) for c in counts]
    new, logs = trainer.train_step(state, *jb, jax.random.key(1))
    # a step with a NaN input, then the finite step, from the same weights
    skip_state = ClassifyState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params0),
        opt_state=trainer.tx.init(
            jax.tree_util.tree_map(jnp.asarray, params0["params"])))
    skip_state, skip_logs = trainer.train_step(
        skip_state, jb[0], jb[1], jb[2].at[0, 0].set(jnp.nan), jb[3],
        jax.random.key(1))
    after_skip, _ = trainer.train_step(skip_state, *jb, jax.random.key(1))
    return dict(batch=batch, params0=params0, params1=_np(new.params),
                mu=_mu(new), loss=float(logs["cla_loss"]),
                acc=float(logs["batch_acc"]), probs=probs,
                eval_loss=eval_loss, counts=counts,
                skipped=float(skip_logs["skipped"]),
                params2=_np(after_skip.params), mu2=_mu(after_skip),
                count2=int(_adam(after_skip).count))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(state):
    return state.opt_state.inner_states["train"].inner_state[1][0]


def _mu(state):
    return _np({k: v for k, v in _adam(state).mu.items() if k != "generator"})


def _assert_step_matches(model, before, after, mu):
    """Updated parameters against JAX's, with the tolerance of the
    module docstring; frozen ones bit-identical to ``before``."""
    mu = state_dict_from_jax(mu)
    before, after = state_dict_from_jax(before), state_dict_from_jax(after)
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), after[name].numpy()
        if not p.requires_grad:
            np.testing.assert_array_equal(got, before[name].numpy())
            continue
        tiny = np.abs(mu[name].numpy()) <= 1e-7      # |g| <= 1e-6
        assert np.all(np.abs(got - want) <= 2.0001 * LR), name
        np.testing.assert_array_less(
            np.abs(got - want)[~tiny],
            1e-6 * np.maximum(1.0, np.abs(want[~tiny])) + 1e-12)


def test_train_step_matches_jax(reference):
    model = _port_model(reference["params0"])
    trainer = ClassifyTrainer(model, lr=LR, mixed_precision="none",
                              device="cpu")
    logs = trainer.train_step(*(torch.from_numpy(v)
                                for v in reference["batch"]))
    np.testing.assert_allclose(logs["cla_loss"], reference["loss"],
                               rtol=1e-5)
    assert logs["batch_acc"] == reference["acc"]
    assert logs["skipped"] == 0.0

    mu = state_dict_from_jax(reference["mu"])
    params = dict(model.named_parameters())
    trainable = {n for n, p in params.items() if p.requires_grad}
    assert trainable == set(mu)
    for name in trainable:
        exp_avg = trainer.optimizer.state[params[name]]["exp_avg"]
        _assert_close(exp_avg, mu[name], name)

    _assert_step_matches(model, reference["params0"], reference["params1"],
                         reference["mu"])


def test_eval_step_matches_jax(reference):
    trainer = ClassifyTrainer(_port_model(reference["params0"]),
                              mixed_precision="none", device="cpu")
    probs, loss, counts = trainer.eval_step(
        *(torch.from_numpy(v) for v in reference["batch"]))
    _assert_close(probs, reference["probs"], "probs", rel=1e-5)
    np.testing.assert_allclose(float(loss), reference["eval_loss"],
                               rtol=1e-5)
    assert [float(c) for c in counts] == reference["counts"]


def test_generator_stays_frozen(reference):
    model = _port_model(reference["params0"])
    gen_before = {k: v.clone() for k, v in
                  model.generator.state_dict().items()}
    trainer = ClassifyTrainer(model, mixed_precision="none", device="cpu")
    model.train()
    assert model.classifier.training
    assert not any(m.training for m in model.generator.modules())
    logs = trainer.train_step(*(torch.from_numpy(v)
                                for v in reference["batch"]))
    assert logs["skipped"] == 0.0
    assert all(p.grad is None and not p.requires_grad
               for p in model.generator.parameters())
    for k, v in model.generator.state_dict().items():
        assert torch.equal(v, gen_before[k]), k
    gen_ids = {id(p) for p in model.generator.parameters()}
    assert not gen_ids & {id(p) for p in trainer.optimizer.state}


def test_finite_guard_skips_the_whole_step(reference):
    """A NaN input moves no parameter and no Adam moment but advances
    Adam's count, as optax's integer count advances under JAX's guard; the
    finite step after it matches JAX's, count 2 on both sides."""
    model = _port_model(reference["params0"])
    trainer = ClassifyTrainer(model, lr=LR, mixed_precision="none",
                              device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mri, x_cat, x_num, labels = (torch.from_numpy(v)
                                 for v in reference["batch"])
    bad = x_num.clone()
    bad[0, 0] = float("nan")
    logs = trainer.train_step(mri, x_cat, bad, labels)
    assert logs["skipped"] == 1.0 == reference["skipped"]
    for p in trainer.trainable.values():
        state = trainer.optimizer.state[p]
        assert state["step"].item() == 1
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    logs = trainer.train_step(mri, x_cat, x_num, labels)
    assert logs["skipped"] == 0.0
    np.testing.assert_allclose(logs["cla_loss"], reference["loss"],
                               rtol=1e-5)
    assert reference["count2"] == 2
    assert all(trainer.optimizer.state[p]["step"].item() == 2
               for p in trainer.trainable.values())
    _assert_step_matches(model, reference["params0"], reference["params2"],
                         reference["mu2"])


def test_bf16_step_sees_generator_weights_loaded_after_construction():
    """The bf16 copy of the frozen generator follows weights loaded into
    it after the trainer was built (the JAX trainer reads the generator
    from its state at every step): logits and the step's loss equal those
    of a trainer built after the load, bit for bit."""
    batch = [torch.from_numpy(v) for v in _batch()]
    new = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2,
                          seed=7, **GEN, **CLS).generator.state_dict()
    trainers = []
    for load_first in (False, True):
        model = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2,
                                cross_ff_dropout=0.0, seed=0, **GEN, **CLS)
        if load_first:
            model.generator.load_state_dict(new)
        trainers.append(ClassifyTrainer(model, lr=LR, device="cpu"))
        if not load_first:
            model.generator.load_state_dict(new)
    with torch.no_grad():
        logits = [tr._logits(*batch[:3]) for tr in trainers]
    assert logits[0].dtype == torch.float32 and torch.equal(*logits)
    losses = [tr.train_step(*batch)["cla_loss"] for tr in trainers]
    assert losses[0] == losses[1]
    assert all(trainers[0].frozen[k].dtype == torch.bfloat16
               and torch.equal(trainers[0].frozen[k], v)
               for k, v in trainers[1].frozen.items())


@pytest.mark.parametrize("preds,targets", [
    (np.random.RandomState(3).rand(32), np.random.RandomState(4).rand(32)
     > 0.5),
    (np.ones(5), np.ones(5)),          # no negatives: mcc's 0/0 is 0
    (np.zeros(4), np.zeros(4)),        # no positives at all
])
def test_metrics_match_jax(preds, targets):
    preds = preds.astype(np.float32)
    targets = targets.astype(np.float32)
    want = jax_metrics.binary_metrics(jnp.asarray(preds),
                                      jnp.asarray(targets))
    got = metrics.binary_metrics(torch.from_numpy(preds),
                                 torch.from_numpy(targets))
    for name in want._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)
    counts = metrics.confusion_counts(torch.from_numpy(preds),
                                      torch.from_numpy(targets))
    total = counts + counts
    assert float(total.tp) == 2 * float(counts.tp)


def test_clips_match_optax():
    rng = np.random.RandomState(5)
    grads = [rng.randn(4, 3).astype(np.float32) * 10,
             rng.randn(5).astype(np.float32) * 0.01]
    tx = clip_by_param_norm(1.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    optim.clip_by_param_norm_(got, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for max_norm in (0.5, 1e3):        # clipped and passed through
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
        got = [torch.from_numpy(g.copy()) for g in grads]
        optim.clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_cast_for_compute_keeps_grads_on_the_masters():
    w = torch.randn(3, requires_grad=True)
    idx = torch.arange(3)
    cast = optim.cast_for_compute({"w": w, "i": idx}, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"] is idx
    cast["w"].float().sum().backward()
    assert w.grad.dtype == torch.float32 and torch.all(w.grad == 1)
    assert optim.compute_dtype("bf16") == torch.bfloat16
    assert optim.compute_dtype("none") == torch.float32
