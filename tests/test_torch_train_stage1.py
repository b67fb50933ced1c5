"""One Stage-1 GAN step of the port (``GanTrainer``) against the JAX
package's, from the same weights and the same numpy volumes, f32 on the
CPU; the discriminator and perceptual-loss forwards; the perceptual
slice indices; the odd-z decoder; and the port-only options (gradient
accumulation, a fresh reconstruction for D, the finite guard).

Tiny generator: ``gcr`` with f_maps (8, 16, 32) and the ViT dropouts at
0, so that no dropout mask enters either side; ``PatchDiscriminator(2,
4)``; ``PerceptualLoss(0.5)``, its trunk carried across with
``state_dict_from_jax``.  After one step Adam's first moment is
0.1 x the (clipped) gradient on both sides, so it stands in for the
gradient.

Tolerances: the five logged losses 1e-4 relative; gradients within 1e-3
of each tensor's largest JAX entry (f32 through the generator, the
SqueezeNet trunk and the discriminator, summed in other orders); the
forwards 1e-4 relative to max(1, max |JAX|); the slice indices exactly.
Parameters after a skipped step and a finite one: Adam at count 2 moves
each entry by about 0.74 lr * sign(g), so entries whose gradient is over
1e-2 of their tensor's largest (ten times the gradient tolerance) and
over 1e-6 agree within 1e-6 * max(1, |p|); the rest, whose sign rounding
may decide, within 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from gfe_mamba_tpu.models.discriminator import \
    PatchDiscriminator as JaxPatchDiscriminator
from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT as JaxGen
from gfe_mamba_tpu.training.gan_trainer import GanState
from gfe_mamba_tpu.training.gan_trainer import GanTrainer as JaxGanTrainer
from gfe_mamba_torch.losses.gan import patch_adversarial_loss
from gfe_mamba_torch.losses.perceptual import (PerceptualLoss,
                                               linspace_indices)
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.unet3d import ResidualMidUNet3DViT
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

IMG = (16, 16, 8)
GEN = dict(f_maps=(8, 16, 32), layer_order="gcr", fold_factor=2,
           vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
           vit_mlp_dim=32, vit_dropout=0.0, vit_emb_dropout=0.0)
LOGS = ("g_loss", "d_loss", "l1", "perceptual", "gen_adv")


def _assert_close(got, want, name="", rel=1e-3):
    """|got - want| <= rel * max |want| (+ a floor for all-zero tensors)."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-9, (name, err)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def reference():
    """JAX models, weights and one train step at adv_on 1 and 0 from the
    same state, shared by the tests below."""
    generator = JaxGen(1, 1, is_segmentation=False, **GEN)
    disc = JaxPatchDiscriminator(num_layers_d=2, num_channels=4)
    perceptual = JaxPerceptual(fake_3d_ratio=0.5)
    trainer = JaxGanTrainer(generator, disc, perceptual,
                            mixed_precision="none", g_init="flax")
    rng = np.random.RandomState(0)
    mri = rng.randn(1, *IMG, 1).astype(np.float32)
    pet = rng.randn(1, *IMG, 1).astype(np.float32)
    g_params = _np(jax.jit(generator.init)(jax.random.key(0),
                                           jnp.asarray(mri)))
    d_params = _np(jax.jit(disc.init)(jax.random.key(1), jnp.asarray(pet)))
    steps = {}
    for adv_on in (1.0, 0.0):
        gp = jax.tree_util.tree_map(jnp.asarray, g_params)
        dp = jax.tree_util.tree_map(jnp.asarray, d_params)
        state = GanState(step=jnp.zeros((), jnp.int32), g_params=gp,
                         d_params=dp, g_opt=trainer.g_tx.init(gp["params"]),
                         d_opt=trainer.d_tx.init(dp["params"]))
        new, logs = trainer.train_step(state, jnp.asarray(mri),
                                       jnp.asarray(pet),
                                       jnp.float32(adv_on),
                                       jax.random.key(2))
        steps[adv_on] = dict(
            logs={k: float(v) for k, v in logs.items()},
            g_mu=_np(new.g_opt[1][0].mu), d_mu=_np(new.d_opt[0].mu),
            d_count=int(new.d_opt[0].count), d_params=_np(new.d_params))
        # a step with a NaN in the PET, then the finite step
        nan_pet = jnp.asarray(pet).at[0, 0, 0, 0, 0].set(jnp.nan)
        state = GanState(step=jnp.zeros((), jnp.int32),
                         g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
                         d_params=jax.tree_util.tree_map(jnp.asarray, d_params),
                         g_opt=trainer.g_tx.init(
                             jax.tree_util.tree_map(jnp.asarray,
                                                    g_params["params"])),
                         d_opt=trainer.d_tx.init(
                             jax.tree_util.tree_map(jnp.asarray,
                                                    d_params["params"])))
        state, logs = trainer.train_step(state, jnp.asarray(mri), nan_pet,
                                         jnp.float32(adv_on),
                                         jax.random.key(2))
        skipped = float(logs["skipped"])
        new, _ = trainer.train_step(state, jnp.asarray(mri),
                                    jnp.asarray(pet), jnp.float32(adv_on),
                                    jax.random.key(2))
        steps[adv_on].update(after_skip=dict(
            skipped=skipped, g_count=int(new.g_opt[1][0].count),
            d_count=int(new.d_opt[0].count), g_mu=_np(new.g_opt[1][0].mu),
            d_mu=_np(new.d_opt[0].mu), g_params=_np(new.g_params),
            d_params=_np(new.d_params)))
    return dict(mri=mri, pet=pet, g_params=g_params, d_params=d_params,
                squeeze=_np(perceptual.params), steps=steps,
                jax_models=(generator, disc, perceptual))


def _port(reference, **kw):
    generator = ResidualMidUNet3DViT(1, 1, img_size=IMG, **GEN)
    generator.load_state_dict(state_dict_from_jax(reference["g_params"]))
    disc = PatchDiscriminator(2, 4)
    disc.load_state_dict(state_dict_from_jax(
        reference["d_params"]))
    perceptual = PerceptualLoss(0.5, device="cpu")
    perceptual.net.load_state_dict(state_dict_from_jax(
        reference["squeeze"]))
    return GanTrainer(generator, disc, perceptual, mixed_precision="none",
                      device="cpu", **kw)


def _exp_avg(opt, params: dict) -> dict:
    return {n: opt.state[p]["exp_avg"] for n, p in params.items()
            if p in opt.state}


@pytest.mark.parametrize("adv_on", [1.0, 0.0])
def test_train_step_matches_jax(reference, adv_on):
    want = reference["steps"][adv_on]
    trainer = _port(reference)
    d_before = {k: v.clone() for k, v in
                trainer.discriminator.state_dict().items()}
    logs = trainer.train_step(torch.from_numpy(reference["mri"]),
                              torch.from_numpy(reference["pet"]), adv_on)
    assert logs["skipped"] == 0.0 == want["logs"]["skipped"]
    for key in LOGS:
        np.testing.assert_allclose(logs[key], want["logs"][key], rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    g_mu = state_dict_from_jax(want["g_mu"])
    g_avg = _exp_avg(trainer.g_opt, trainer.g_params)
    assert set(g_avg) == set(g_mu)
    for name, v in g_avg.items():
        _assert_close(v, g_mu[name], name)
    if adv_on:
        d_mu = state_dict_from_jax(want["d_mu"])
        d_avg = _exp_avg(trainer.d_opt, trainer.d_params)
        assert set(d_avg) == set(d_mu)
        for name, v in d_avg.items():
            _assert_close(v, d_mu[name], name)
    else:
        # warm-up: neither D nor its Adam state moves, on either side
        assert want["d_count"] == 0 and not trainer.d_opt.state
        for k, v in trainer.discriminator.state_dict().items():
            assert torch.equal(v, d_before[k]), k
        for a, b in zip(jax.tree_util.tree_leaves(want["d_params"]),
                        jax.tree_util.tree_leaves(reference["d_params"])):
            np.testing.assert_array_equal(a, b)


def test_discriminator_forward_matches_jax(reference):
    """All features, at a toy size where the padding widens."""
    _, disc, _ = reference["jax_models"]
    x = np.random.RandomState(1).randn(2, *IMG, 1).astype(np.float32)
    want = disc.apply(reference["d_params"], jnp.asarray(x))
    port = PatchDiscriminator(2, 4)
    port.load_state_dict(state_dict_from_jax(
        reference["d_params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_close(a, b, f"feature {i}", rel=1e-4)


def test_perceptual_forward_matches_jax(reference):
    """Slices under 32 px (upsampled) and over it, 1 channel."""
    _, _, perceptual = reference["jax_models"]
    rng = np.random.RandomState(2)
    pred = rng.randn(1, 36, 34, 10, 1).astype(np.float32)
    target = rng.randn(1, 36, 34, 10, 1).astype(np.float32)
    want = float(jax.jit(lambda a, b: perceptual(a, b))(
        jnp.asarray(pred), jnp.asarray(target)))
    port = PerceptualLoss(0.5, device="cpu")
    port.net.load_state_dict(state_dict_from_jax(
        reference["squeeze"]))
    with torch.no_grad():
        got = float(port(torch.from_numpy(pred), torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_perceptual_loss_reads_a_jax_weights_file(tmp_path):
    """``weights_path``: the npz of ``{"params": tree}`` that
    ``tools/convert_squeezenet.py`` writes, here saved from a JAX loss
    drawn from a non-default seed; both packages read it and give the
    same loss, and not the port's seeded trunk's.  Tolerance 1e-4
    relative, as the forward test above: JAX's f32 loss lies some 2e-5
    from the f64 value of the same function on this input, the port's f32
    loss within 1e-6 of the port's f64 one (held too)."""
    jax_seeded = JaxPerceptual(fake_3d_ratio=0.5, seed=7)
    path = str(tmp_path / "squeezenet.npz")
    np.savez(path, params=np.asarray(_np(jax_seeded.params), dtype=object))
    rng = np.random.RandomState(4)
    pred, target = (rng.randn(1, 36, 34, 10, 1).astype(np.float32)
                    for _ in range(2))
    want = float(jax.jit(lambda a, b: JaxPerceptual(
        fake_3d_ratio=0.5, weights_path=path)(a, b))(
        jnp.asarray(pred), jnp.asarray(target)))
    port = PerceptualLoss(0.5, device="cpu", weights_path=path)
    seeded = PerceptualLoss(0.5, device="cpu", seed=7)
    with torch.no_grad():
        got, other = (float(m(torch.from_numpy(pred),
                              torch.from_numpy(target)))
                      for m in (port, seeded))
        exact = float(port.double()(torch.from_numpy(pred).double(),
                                    torch.from_numpy(target).double()))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    assert abs(other - want) > 1e-3 * abs(want)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_perceptual_slice_indices_equal_jax(ratio):
    for n in range(1, 257):
        take = max(1, int(n * ratio))
        want = np.asarray(jnp.linspace(0, n - 1, take).astype(jnp.int32))
        np.testing.assert_array_equal(linspace_indices(n, take).numpy(),
                                      want, err_msg=f"n={n} take={take}")


def test_decoder_resizes_an_odd_z_like_jax():
    """(16, 16, 12): the bottleneck z extent is 3, so the first decoder
    takes the 2n-1 deconv and the nearest resize to the skip."""
    img = (16, 16, 12)
    kw = dict(GEN, fold_factor=2, vit_patch_size=2)
    generator = JaxGen(1, 1, is_segmentation=False, **kw)
    x = np.random.RandomState(3).randn(1, *img, 1).astype(np.float32)
    params = jax.jit(generator.init)(jax.random.key(4), jnp.asarray(x))
    want = generator.apply(params, jnp.asarray(x))
    port = ResidualMidUNet3DViT(1, 1, img_size=img, **kw)
    port.load_state_dict(state_dict_from_jax(_np(params)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _assert_close(got, want, "pet", rel=1e-4)


def test_gradient_accumulation_averages_microbatches(reference):
    """accum_steps=2 on a batch of 2 gives G and D the mean of the two
    single-microbatch gradients (G's after the global clip)."""
    rng = np.random.RandomState(5)
    mri = torch.from_numpy(rng.randn(2, *IMG, 1).astype(np.float32))
    pet = torch.from_numpy(rng.randn(2, *IMG, 1).astype(np.float32))
    single = _port(reference)
    g_parts, d_parts = [], []
    for i in range(2):
        loss_g, recon, _ = single._g_loss(mri[i:i + 1], pet[i:i + 1], 1.0)
        g_parts.append(single._grads(loss_g, single.g_params))
        loss_d = single._d_loss(recon, pet[i:i + 1], 1.0)
        d_parts.append(single._grads(loss_d, single.d_params))
    g_mean = [(a + b) / 2 for a, b in zip(*g_parts)]
    norm = torch.sqrt(sum(g.square().sum() for g in g_mean))
    g_mean = [g if norm < 1.0 else g / norm for g in g_mean]
    d_mean = [(a + b) / 2 for a, b in zip(*d_parts)]

    trainer = _port(reference, accum_steps=2)
    assert trainer.train_step(mri, pet, 1.0)["skipped"] == 0.0
    for (name, p), g in zip(trainer.g_params.items(), g_mean):
        _assert_close(trainer.g_opt.state[p]["exp_avg"], 0.1 * g, name,
                      rel=1e-5)
    for (name, p), g in zip(trainer.d_params.items(), d_mean):
        _assert_close(trainer.d_opt.state[p]["exp_avg"], 0.1 * g, name,
                      rel=1e-5)


def test_fresh_reconstruction_trains_d_on_the_updated_generator(reference):
    trainer = _port(reference, d_fresh_recon=True)
    mri = torch.from_numpy(reference["mri"])
    pet = torch.from_numpy(reference["pet"])
    logs = trainer.train_step(mri, pet, 1.0)
    assert logs["skipped"] == 0.0
    d_exp_avg = [trainer.d_opt.state[p]["exp_avg"].clone()
                 for p in trainer.d_params.values()]
    # D's update used the gradient at its old weights: undo it to recompute
    fresh = _port(reference)
    fresh.generator.load_state_dict(trainer.generator.state_dict())
    with torch.no_grad():
        recon = fresh._recon(mri)
    want = fresh._grads(fresh._d_loss(recon, pet, 1.0), fresh.d_params)
    stale = _port(reference)
    with torch.no_grad():
        old_recon = stale._recon(mri)
    old = stale._grads(stale._d_loss(old_recon, pet, 1.0), stale.d_params)
    for a, b, c in zip(d_exp_avg, want, old):
        _assert_close(a, 0.1 * b, rel=1e-5)
    assert any((b - c).abs().max() > 0 for b, c in zip(want, old))


def _nan_pet(reference):
    pet = torch.from_numpy(reference["pet"]).clone()
    pet[0, 0, 0, 0, 0] = float("nan")
    return pet


def _counts(opt, params: dict) -> set:
    return {opt.state[p]["step"].item() if p in opt.state else 0
            for p in params.values()}


def test_finite_guard_moves_neither_player(reference):
    """Neither player's parameters nor Adam moments move; both Adam
    counts advance, as optax's integer counts do under JAX's guard."""
    trainer = _port(reference)
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (trainer.generator, trainer.discriminator)]
    logs = trainer.train_step(torch.from_numpy(reference["mri"]),
                              _nan_pet(reference), 1.0)
    assert logs["skipped"] == 1.0
    for opt, params in ((trainer.g_opt, trainer.g_params),
                        (trainer.d_opt, trainer.d_params)):
        assert _counts(opt, params) == {1}
        assert not any(opt.state[p][k].any() for p in params.values()
                       for k in ("exp_avg", "exp_avg_sq"))
    for m, b in zip((trainer.generator, trainer.discriminator), before):
        for k, v in m.state_dict().items():
            assert torch.equal(v, b[k]), k


def _assert_params_match(model, want, mu, lr):
    """Parameters after Adam's step at count 2, against JAX's, with the
    tolerance of the module docstring."""
    want, mu = state_dict_from_jax(want), state_dict_from_jax(mu)
    for name, p in model.named_parameters():
        got, w, g = p.detach().numpy(), want[name].numpy(), mu[name].numpy()
        err = np.abs(got - w)
        assert np.all(err <= 2.0001 * lr), name
        big = np.abs(g) > np.maximum(1e-2 * np.abs(g).max(), 1e-7)
        np.testing.assert_array_less(
            err[big], 1e-6 * np.maximum(1.0, np.abs(w[big])) + 1e-12, name)


@pytest.mark.parametrize("adv_on", [1.0, 0.0])
def test_skipped_then_finite_step_matches_jax(reference, adv_on):
    """After a NaN step, G's count reads 2 after the finite step, and
    D's too with the adversary on; in the warm-up D's count stays 0 and
    D does not move, on both sides."""
    want = reference["steps"][adv_on]["after_skip"]
    trainer = _port(reference)
    mri = torch.from_numpy(reference["mri"])
    assert trainer.train_step(mri, _nan_pet(reference), adv_on)[
        "skipped"] == 1.0 == want["skipped"]
    logs = trainer.train_step(mri, torch.from_numpy(reference["pet"]),
                              adv_on)
    assert logs["skipped"] == 0.0
    assert want["g_count"] == 2 and _counts(trainer.g_opt,
                                            trainer.g_params) == {2}
    _assert_params_match(trainer.generator, want["g_params"], want["g_mu"],
                         trainer.g_opt.param_groups[0]["lr"])
    if adv_on:
        assert want["d_count"] == 2 and _counts(trainer.d_opt,
                                                trainer.d_params) == {2}
        _assert_params_match(trainer.discriminator, want["d_params"],
                             want["d_mu"],
                             trainer.d_opt.param_groups[0]["lr"])
    else:
        assert want["d_count"] == 0 and not trainer.d_opt.state
        for a, b in zip(jax.tree_util.tree_leaves(want["d_params"]),
                        jax.tree_util.tree_leaves(reference["d_params"])):
            np.testing.assert_array_equal(a, b)
        for name, p in trainer.discriminator.named_parameters():
            np.testing.assert_array_equal(
                p.detach().numpy(),
                state_dict_from_jax(reference["d_params"])[name].numpy())


@pytest.mark.parametrize("criterion", ["least_squares", "bce", "hinge"])
def test_adversarial_losses_match_jax(criterion):
    from gfe_mamba_tpu.losses.gan import \
        patch_adversarial_loss as jax_patch_adversarial_loss
    rng = np.random.RandomState(6)
    logits = [rng.randn(2, 3, 3, 2, 1).astype(np.float32) for _ in range(2)]
    for real, for_d in ((True, True), (False, True), (False, False)):
        for arg in (logits[0], logits):
            jarg = [jnp.asarray(v) for v in arg] if isinstance(arg, list) \
                else jnp.asarray(arg)
            targ = [torch.from_numpy(v) for v in arg] \
                if isinstance(arg, list) else torch.from_numpy(arg)
            want = float(jax_patch_adversarial_loss(jarg, real, for_d,
                                                    criterion))
            got = float(patch_adversarial_loss(targ, real, for_d, criterion))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
