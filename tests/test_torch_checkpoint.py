"""Checkpoints across the two packages, remat and auto-resume.

* npz: a JAX ``save_params_npz`` of the generator, the combiner and the
  classifier loads into the port, and the port's loads through JAX's
  ``load_params_npz``, bit for bit both ways; the forwards then agree
  within 1e-4 * max(1, max |JAX|) at f32 (the tolerance of
  ``tests/test_torch_pipeline.py``, whose configurations these are, so
  the JAX compiles are shared).
* ``jax_tree_from_state_dict(state_dict_from_jax(t)) == t`` over every
  key of the JAX trees (both layer orders, the discriminator).
* A ``.pth`` of the port's ``state_dict`` loads through JAX's
  ``import_generator`` / ``import_combiner`` / ``import_classifier``.
* ``remat``: with the ViT's dropout 0.1 drawing, in f32 and in bf16,
  the loss, the gradients and the dropout stream are bitwise those of
  the plain forward; a block that holds a ``Dropout`` is refused.
* ``AutoResume`` restores the newest slot, and a trainer's full state
  (weights, both Adams, the dropout generator) comes back bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gfe_mamba_tpu.models.discriminator import \
    PatchDiscriminator as JaxPatchDiscriminator
from gfe_mamba_tpu.models.pipeline import build_gfe_mamba as jax_build
from gfe_mamba_tpu.training.checkpoint import \
    load_params_npz as jax_load_params_npz
from gfe_mamba_tpu.training.checkpoint import \
    save_params_npz as jax_save_params_npz
from gfe_mamba_tpu.utils.torch_import import (import_classifier,
                                              import_combiner,
                                              import_generator,
                                              load_torch_state_dict)
from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.dropout import Dropout, seed_dropout
from gfe_mamba_torch.models.pipeline import build_gfe_mamba, build_generator
from gfe_mamba_torch.models.unet3d import remat_call
from gfe_mamba_torch.training.checkpoint import (load_params_npz,
                                                 save_params_npz)
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.training.resilience import AutoResume
from gfe_mamba_torch.utils.convert import (flatten_tree,
                                           jax_tree_from_state_dict,
                                           state_dict_from_jax)

# one thread: the bitwise comparisons of two runs below need it (with two,
# the CPU's f32 reductions differ in the last bits now and then)
torch.set_num_threads(1)

IMG = (16, 16, 8)
TINY = dict(categories=(3, 5, 2), num_continuous=4, depth=1, heads=2,
            seq_length=2, fold_factor=2, vit_patch_size=4, vit_dim=16,
            vit_depth=1, vit_heads=2, vit_mlp_dim=32)
CONFIGS = {
    "quick_cge": dict(TINY, dim=32, f_maps=(4, 8, 16), layer_order="cge"),
    "gcr": dict(TINY, dim=64, f_maps=(8, 16, 32), layer_order="gcr"),
}
PARTS = ("generator", "combiner", "classifier")


def _assert_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _assert_trees_equal(got: dict, want: dict):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture(scope="module", params=list(CONFIGS))
def reference(request):
    """One JAX init and forward per config (``test_torch_pipeline.py``'s)
    and the jitted forward, shared by the tests below."""
    kw = CONFIGS[request.param]
    model = jax_build(**kw)
    rng = np.random.RandomState(0)
    inputs = (rng.randn(2, *IMG, 1).astype(np.float32),
              rng.randint(0, 2, (2, 3)).astype(np.int32),
              rng.randn(2, 4).astype(np.float32))
    jin = [jnp.asarray(v) for v in inputs]
    params = jax.jit(model.init)(jax.random.key(0), *jin)
    forward = jax.jit(lambda p, *a: model.apply(p, *a, return_pet=True))
    params = jax.tree_util.tree_map(np.asarray, params)
    return kw, params, inputs, forward


def _port(kw, seed=0):
    return build_gfe_mamba(img_size=IMG, device="cpu", seed=seed, **kw)


def _port_forward(model, inputs):
    with torch.no_grad():
        logits, pet = model(*(torch.from_numpy(v) for v in inputs),
                            return_pet=True)
    return logits.numpy(), pet.numpy()


def test_jax_npz_loads_into_port_bitwise(reference, tmp_path):
    kw, params, inputs, forward = reference
    model = _port(kw, seed=5)
    for part in PARTS:
        path = str(tmp_path / f"{part}.npz")
        jax_save_params_npz(path, params["params"][part])
        load_params_npz(path, getattr(model, part))
        want = state_dict_from_jax(params["params"][part])
        got = getattr(model, part).state_dict()
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (part, key)
    logits, pet = forward(params, *(jnp.asarray(v) for v in inputs))
    got_logits, got_pet = _port_forward(model, inputs)
    _assert_close(got_logits, logits)
    _assert_close(got_pet, pet)


def test_port_npz_loads_into_jax_bitwise(reference, tmp_path):
    kw, params, inputs, forward = reference
    model = _port(kw, seed=7)
    loaded = {}
    for part in PARTS:
        path = str(tmp_path / f"{part}.npz")
        save_params_npz(path, getattr(model, part), kw["layer_order"])
        loaded[part] = jax_load_params_npz(path, params["params"][part])
        _assert_trees_equal(
            loaded[part],
            jax_tree_from_state_dict(getattr(model, part).state_dict(),
                                     kw["layer_order"]))
        back = state_dict_from_jax(loaded[part])
        for key, value in getattr(model, part).state_dict().items():
            assert torch.equal(back[key], value), (part, key)
    logits, pet = forward({"params": loaded},
                          *(jnp.asarray(v) for v in inputs))
    got_logits, got_pet = _port_forward(model, inputs)
    _assert_close(got_logits, logits)
    _assert_close(got_pet, pet)


def test_inverse_conversion_over_every_jax_key(reference):
    kw, params, _, _ = reference
    tree = params["params"]
    _assert_trees_equal(
        jax_tree_from_state_dict(state_dict_from_jax(tree),
                                 kw["layer_order"]), tree)
    for part in PARTS:
        _assert_trees_equal(
            jax_tree_from_state_dict(state_dict_from_jax(tree[part]),
                                     kw["layer_order"]), tree[part])


def test_inverse_conversion_of_the_discriminator():
    disc = JaxPatchDiscriminator(num_layers_d=2, num_channels=4)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(disc.init)(
        jax.random.key(1), jnp.zeros((1, *IMG, 1)))["params"])
    _assert_trees_equal(jax_tree_from_state_dict(state_dict_from_jax(tree)),
                        tree)
    port = PatchDiscriminator(2, 4)
    port.reset_parameters(torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax(tree))


def test_port_pth_loads_through_jax_import(reference, tmp_path):
    kw, params, _, _ = reference
    model = _port(kw, seed=9)
    importers = dict(generator=import_generator, combiner=import_combiner,
                     classifier=import_classifier)
    for part, importer in importers.items():
        path = str(tmp_path / f"{part}.pth")
        torch.save(getattr(model, part).state_dict(), path)
        got = importer(load_torch_state_dict(path), params["params"][part])
        _assert_trees_equal(
            jax.tree_util.tree_map(np.asarray, got),
            jax_tree_from_state_dict(getattr(model, part).state_dict(),
                                     kw["layer_order"]))


GEN = dict(f_maps=(8, 16, 32), fold_factor=2, vit_patch_size=4, vit_dim=16,
           vit_depth=1, vit_heads=2, vit_mlp_dim=32)


def _gan_trainer(remat=False, seed=0, mixed_precision="none"):
    disc = PatchDiscriminator(2, 4)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    return GanTrainer(build_generator(img_size=IMG, device="cpu", seed=0,
                                      remat=remat, **GEN),
                      disc, PerceptualLoss(0.5, device="cpu"), device="cpu",
                      mixed_precision=mixed_precision, seed=seed)


@pytest.mark.parametrize("mixed_precision", ["none", "bf16"])
def test_remat_gradients_equal_plain_with_dropout(mixed_precision):
    """The generator at its default ViT dropout 0.1: loss and every
    generator gradient bitwise equal with remat on and off.  In bf16 the
    recomputation must see the trainer's bf16 compute copies, not the
    f32 masters, for this to hold: the weights are moved off their init
    values (GroupNorm's 1 and 0 are exact in bf16) so that the two
    differ."""
    rng = np.random.RandomState(0)
    mri, pet = (torch.from_numpy(rng.randn(1, *IMG, 1).astype(np.float32))
                for _ in range(2))
    runs = []
    for remat in (False, True):
        trainer = _gan_trainer(remat, mixed_precision=mixed_precision)
        noise = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for param in trainer.g_params.values():
                param.add_(1e-3 * torch.randn(param.shape, generator=noise))
        trainer.generator.train()
        loss, _, _ = trainer._g_loss(mri, pet, 1.0)
        runs.append((loss.detach(), trainer._grads(loss, trainer.g_params),
                     trainer.rng.get_state()))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][2], runs[1][2])


def test_remat_call_refuses_a_block_that_draws_dropout():
    """Recomputing a block that draws dropout would draw new masks:
    ``remat_call`` raises, and without a gradient it is a plain call."""
    block = nn.Sequential(nn.Linear(16, 32), Dropout(0.1)).train()
    seed_dropout(block, torch.Generator().manual_seed(3))
    x = torch.randn(4, 8, 16, requires_grad=True)
    with pytest.raises(ValueError, match="dropout"):
        remat_call(block, x)
    block.eval()
    with torch.no_grad():
        assert torch.equal(remat_call(block, x), block(x))


def test_autoresume_restores_the_newest_slot(tmp_path):
    auto = AutoResume(str(tmp_path), interval=2, keep=2)
    assert not auto.maybe_save(0, {"x": 0})
    assert not auto.maybe_save(3, {"x": 3})
    for step in (2, 4, 6):
        assert auto.maybe_save(step, {"x": step})
    assert auto.maybe_save(7, {"x": 7}, force=True)
    assert AutoResume(str(tmp_path), keep=2).restore_latest() \
        == (7, {"x": 7})
    assert AutoResume(str(tmp_path / "empty")).restore_latest() == (0, None)


def test_trainer_state_round_trips_through_autoresume(tmp_path):
    rng = np.random.RandomState(1)
    mri, pet = (torch.from_numpy(rng.randn(1, *IMG, 1).astype(np.float32))
                for _ in range(2))
    trainer = _gan_trainer(seed=4)
    trainer.train_step(mri, pet, 1.0)
    auto = AutoResume(str(tmp_path), interval=1)
    auto.maybe_save(1, {"gan": trainer.state_dict(), "epoch": 3})
    step, payload = AutoResume(str(tmp_path)).restore_latest()
    fresh = _gan_trainer(seed=0)
    fresh.load_state_dict(payload["gan"])
    assert (step, payload["epoch"], fresh.step) == (1, 3, 1)
    for a, b in ((trainer.generator, fresh.generator),
                 (trainer.discriminator, fresh.discriminator)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    for a, b in ((trainer.g_opt, fresh.g_opt), (trainer.d_opt, fresh.d_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for key in sa[i]:
                assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert torch.equal(trainer.rng.get_state(), fresh.rng.get_state())
    # both take the same next step
    logs_a = trainer.train_step(mri, pet, 1.0)
    logs_b = fresh.train_step(mri, pet, 1.0)
    assert logs_a == logs_b
