"""The port's ``models/vit_zoo.py`` against the JAX package's, on the CPU
at tiny widths.

Each JAX model is initialized, every parameter moved off its init (so a
bias or a norm mapped to the wrong place shows), carried to the port by
``utils/convert.py::state_dict_from_jax(variables, model)`` and loaded
strictly; both run the same numpy input.  Tolerance: 1e-5 relative to
max(1, max |JAX|) for outputs and for gradients (against ``jax.grad``);
JAX runs at matmul precision 'highest' (``tests/conftest.py``).  MAE's
masking is drawn by JAX's own calls and handed to the port's
``MAE.permutation``; the port's draw is held to its law separately.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo as jz
from gfe_mamba_torch.models import vit_zoo as pz
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


def _carry(jmod, port, *args, seed=0, **kw):
    """JAX variables from ``init`` with every leaf moved off its init,
    loaded into ``port``; returns them."""
    variables = jax.jit(jmod.init)(jax.random.key(seed), *args, **kw)
    rng = np.random.RandomState(seed + 1)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), variables)
    port.load_state_dict(state_dict_from_jax(variables, port))
    return variables


def _jax(jmod, variables, x):
    return jax.jit(jmod.apply)(variables, jnp.asarray(x))


def _grads_close(port, jax_grads, tag):
    want = state_dict_from_jax(jax_grads, port)
    got = dict(port.named_parameters())
    assert set(want) == set(got), tag
    for key, value in want.items():
        _close(got[key].grad, value.numpy(), f"{tag} {key}")


def test_posemb_sincos_2d_matches_jax():
    _close(pz._posemb_sincos_2d(3, 5, 16),
           jz._posemb_sincos_2d(3, 5, 16))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_classifier_vit_matches_jax(pool):
    kw = dict(image_size=(16, 24), patch_size=(8, 4), num_classes=5, dim=32,
              depth=2, heads=2, mlp_dim=48, pool=pool, dim_head=16)
    x = np.random.RandomState(0).rand(2, 16, 24, 3).astype(np.float32)
    jmod = jz.ClassifierViT(**kw)
    port = pz.ClassifierViT(**kw, channels=3).eval()
    v = _carry(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), _jax(jmod, v, x), pool)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit3d_matches_jax(pool):
    kw = dict(image_size=(16, 8), image_depth=12, patch_size=4,
              depth_patch_size=6, num_classes=3, dim=32, depth=2, heads=2,
              mlp_dim=40, pool=pool, dim_head=16)
    x = np.random.RandomState(1).randn(2, 16, 8, 12, 2).astype(np.float32)
    jmod = jz.ViT3D(**kw)
    port = pz.ViT3D(**kw, channels=2).eval()
    v = _carry(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), _jax(jmod, v, x), pool)


def test_vit3d_gradients_match_jax():
    kw = dict(image_size=(8, 8), image_depth=8, patch_size=4,
              depth_patch_size=4, num_classes=3, dim=32, depth=1, heads=2,
              mlp_dim=32, dim_head=16)
    x = np.random.RandomState(2).randn(2, 8, 8, 8, 1).astype(np.float32)
    jmod = jz.ViT3D(**kw)
    port = pz.ViT3D(**kw, channels=1).train()
    v = _carry(jmod, port, jnp.asarray(x))
    loss = (lambda p: jnp.sum(jnp.sin(jmod.apply({"params": p},
                                                  jnp.asarray(x)))))
    want = jax.jit(jax.grad(loss))(v["params"])
    port(torch.from_numpy(x)).sin().sum().backward()
    _grads_close(port, want, "ViT3D")


def test_simple_vit_matches_jax():
    kw = dict(image_size=16, patch_size=4, num_classes=4, dim=32, depth=2,
              heads=2, mlp_dim=32, dim_head=16)
    x = np.random.RandomState(3).rand(2, 16, 16, 3).astype(np.float32)
    jmod = jz.SimpleViT(**kw)
    port = pz.SimpleViT(**kw).eval()
    v = _carry(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), _jax(jmod, v, x))


def test_mae_loss_and_gradients_match_jax():
    """The loss and every gradient, with JAX's permutation handed over."""
    kw = dict(image_size=16, patch_size=4, dim=32, depth=2, heads=2,
              mlp_dim=32, masking_ratio=0.75, decoder_dim=24,
              decoder_depth=1, decoder_heads=2, dim_head=8)
    x = np.random.RandomState(4).rand(3, 16, 16, 3).astype(np.float32)
    rng = jax.random.key(7)
    jmod = jz.MAE(**kw)
    port = pz.MAE(**kw)
    v = _carry(jmod, port, jnp.asarray(x), rng)
    perm = jax.vmap(lambda k: jax.random.permutation(k, 16))(
        jax.random.split(rng, 3))
    port.permutation = lambda b, n, g, d: torch.from_numpy(
        np.asarray(perm, np.int64))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply({"params": p}, jnp.asarray(x), rng)))(
        v["params"])
    got = port(torch.from_numpy(x), torch.Generator())
    _close(got, loss, "loss")
    got.backward()
    _grads_close(port, grads, "MAE")


def test_mae_permutation_law():
    """One permutation of n per sample, reproducible from the generator's
    seed, each position's first slot near uniform over 4000 draws."""
    a = pz.MAE.permutation(4000, 5, torch.Generator().manual_seed(0), "cpu")
    b = pz.MAE.permutation(4000, 5, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(a, b)
    assert torch.equal(a.sort(dim=1).values,
                       torch.arange(5).expand(4000, 5))
    freq = torch.bincount(a[:, 0], minlength=5).double() / 4000
    assert (freq - 0.2).abs().max() < 0.03, freq


def test_dino_head_and_loss_match_jax():
    x = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    jmod = jz.DinoHead(projection_hidden=24, projection_out=12)
    port = pz.DinoHead(24, 12, dim=16)
    v = _carry(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), _jax(jmod, v, x), "head")
    rs = np.random.RandomState(6)
    s, t = (rs.randn(4, 12).astype(np.float32) for _ in range(2))
    center = rs.randn(12).astype(np.float32)
    for c in (None, center):
        ts, tt = torch.from_numpy(s).requires_grad_(), torch.from_numpy(t)
        got = pz.dino_loss(ts, tt, 0.1, 0.04,
                           None if c is None else torch.from_numpy(c))
        want, grad = jax.value_and_grad(lambda a: jz.dino_loss(
            a, jnp.asarray(t), 0.1, 0.04,
            None if c is None else jnp.asarray(c)))(jnp.asarray(s))
        _close(got, want, "dino_loss")
        got.backward()
        _close(ts.grad, grad, "dino_loss grad")


def test_ema_update_matches_jax():
    teacher, student = pz.DinoHead(8, 6, dim=4), pz.DinoHead(8, 6, dim=4)
    gen = torch.Generator().manual_seed(3)
    pz.init_zoo(teacher, gen)
    pz.init_zoo(student, gen)
    t_tree = {k: v.numpy().copy() for k, v in teacher.state_dict().items()}
    s_tree = {k: v.numpy().copy() for k, v in student.state_dict().items()}
    want = jz.ema_update(t_tree, s_tree, 0.9)
    assert pz.ema_update(teacher, student, 0.9) is teacher
    for key, value in teacher.state_dict().items():
        _close(value, want[key], key)
