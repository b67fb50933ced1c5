"""The port's ``models/vit_zoo_hier.py`` against the JAX package's, on the
CPU at tiny widths.

Each JAX model is initialized, every variable moved off its init, carried
to the port by ``state_dict_from_jax(variables, model)`` and loaded
strictly; both run the same numpy input, on non-square maps wherever the
JAX module takes them (a transposed window or grid partition then shows).
Eval outputs agree within 1e-5 relative to max(1, max |JAX|) in f32.  The
train-mode BatchNorms of LeViT, MaxViT's MBConv and XCiT's local patch
interaction over a few values amplify f32 rounding, so train mode runs in
f64 on both sides at 1e-6, the running statistics it moves included, as
``test_torch_vit_zoo_extra.py`` does for MobileViT.  MBConv's dropsample
takes the keep draw JAX makes.  The index tables equal JAX's exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo_hier as jh
from gfe_mamba_torch.models import vit_zoo_hier as ph
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag="", rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, (tag, err)


def _carry(jmod, port, x, seed=0, **kwargs):
    """JAX variables from ``init`` with every leaf moved off its init
    (running variances kept positive), loaded into ``port``."""
    variables = jax.jit(partial(jmod.init, **kwargs))(jax.random.key(seed),
                                                      jnp.asarray(x))
    rng = np.random.RandomState(seed + 1)

    def move(path, a):
        a = np.asarray(a)
        noise = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "var":
            noise = np.abs(noise)
        return jnp.asarray(a + noise)

    variables = jax.tree_util.tree_map_with_path(move, variables)
    port.load_state_dict(state_dict_from_jax(variables, port))
    return variables


def _img(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


TABLES = {
    "rel_bias_2": (lambda m: m._rel_bias_indices(2)),
    "rel_bias_7": (lambda m: m._rel_bias_indices(7)),
    "levit_4": (lambda m: m._levit_pos_indices(4, False)),
    "levit_5_down": (lambda m: m._levit_pos_indices(5, True)),
    "crossformer_3": (lambda m: m._crossformer_bias_tables(3)),
    "crossformer_7": (lambda m: m._crossformer_bias_tables(7)),
    "region_2x3_w3": (lambda m: m._region_local_bias_indices(2, 3, 3)),
    "region_7x7_w7": (lambda m: m._region_local_bias_indices(7, 7, 7)),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_index_tables_equal_jax(name):
    got, want = TABLES[name](ph), TABLES[name](jh)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


MODELS = {
    "LeViT": (dict(image_size=64, num_classes=3, dim=(16, 24, 32), depth=1,
                   heads=(2, 3, 4), dim_key=8, dim_value=8),
              (2, 64, 64, 3), {}),
    "LeViT-distill": (dict(image_size=64, num_classes=3, dim=(16, 24, 32),
                           depth=(1, 2, 1), heads=(2, 3, 4), dim_key=8,
                           dim_value=8, num_distill_classes=5),
                      (2, 64, 64, 3), {}),
    "MaxViT": (dict(num_classes=3, dim=16, depth=(1, 2), dim_head=8,
                    window_size=2), (2, 32, 48, 3), {}),
    "TwinsSVT": (dict(num_classes=3, embed_dims=(8, 16, 16, 24),
                      depths=(1, 1, 1, 1), local_patch_sizes=(2, 2, 2, 2),
                      global_ks=(2, 2, 2, 2), heads=2, dim_head=8),
                 (2, 64, 96, 3), {}),
    "XCiT": (dict(image_size=(16, 24), patch_size=4, num_classes=3, dim=16,
                  depth=2, cls_depth=2, heads=2, mlp_dim=24, dim_head=8),
             (2, 16, 24, 3), {}),
    "CrossFormer": (dict(num_classes=3, dim=(32, 32, 64, 64),
                         depth=(1, 1, 1, 1), global_window_size=(2, 2, 2, 1),
                         local_window_size=(2, 2, 2, 1)),
                    (2, 64, 96, 3), {}),
    "RegionViT": (dict(num_classes=3, dim=(8, 16, 16, 16), depth=(1, 1, 1, 1),
                       window_size=2, local_patch_size=4),
                  (2, 64, 128, 3), {}),
    "RegionViT-peg": (dict(num_classes=3, dim=(8, 16, 16, 16),
                           depth=(1, 2, 1, 1), window_size=2,
                           local_patch_size=4, use_peg=True),
                      (2, 64, 128, 3), {}),
    "ScalableViT": (dict(num_classes=3, dim=8, depth=(1, 2), heads=(1, 2),
                         reduction_factor=(2, 1), window_size=(2, None),
                         iwsa_dim_key=8, iwsa_dim_value=8, ssa_dim_key=8,
                         ssa_dim_value=8), (2, 32, 48, 3), {}),
    "SepViT": (dict(num_classes=3, dim=8, depth=(1, 2, 1), heads=(1, 2, 2),
                    window_size=(2, 2, 1), dim_head=8),
               (2, 32, 48, 3), dict(image_size=(32, 48))),
    "SepViT-one-window": (dict(num_classes=3, dim=8, depth=(1, 1),
                               heads=(1, 2), window_size=(2, 4), dim_head=8),
                          (2, 32, 32, 2),
                          dict(image_size=32, channels=2)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    kw, shape, extra = MODELS[name]
    cls = name.split("-")[0]
    x = _img(len(name), *shape)
    jmod = getattr(jh, cls)(**kw)
    port = getattr(ph, cls)(**kw, **extra).eval()
    v = _carry(jmod, port, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = jax.jit(jmod.apply)(v, jnp.asarray(x))
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{name} output {i}")
    else:
        _close(got, want, name)


def _train_f64(jmod, port, x, v):
    """The port's train-mode forward in f64 against JAX's, and the running
    statistics each moves."""
    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        out, moved = jax.jit(partial(jmod.apply, train=True,
                                     mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
        out, moved = jax.tree_util.tree_map(np.asarray, (out, moved))
    assert np.asarray(out if not isinstance(out, tuple) else out[0]) \
        .dtype == np.float64
    return got, out, moved


TRAIN = {
    "LeViT": MODELS["LeViT-distill"],
    "MaxViT": (dict(MODELS["MaxViT"][0], dropout=0.0), (4, 32, 48, 3), {}),
    "XCiT": (MODELS["XCiT"][0], (4, 16, 24, 3), {}),
}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_mode_batchnorm_matches_jax_in_f64(name):
    kw, shape, extra = TRAIN[name]
    x = _img(20 + len(name), *shape)
    jmod = getattr(jh, name)(**kw)
    port = getattr(ph, name)(**kw, **extra)
    v = _carry(jmod, port, x)
    got, want, moved = _train_f64(jmod, port, x, v)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        _close(a, b, f"{name} train", 1e-6)
    after = state_dict_from_jax({"params": v["params"], **moved}, port)
    state = port.state_dict()
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        _close(state[key], after[key].numpy(), key, 1e-6)


def test_mbconv_dropsample_matches_jax(monkeypatch):
    """Train mode with dropsample 0.5 in f64: the port's ``DropPath``
    takes the keep draw JAX's ``make_rng('dropout')`` gives, so the kept
    and dropped samples and the scaled residual agree."""
    x = _img(30, 6, 4, 6, 8)
    jmod = jh._MBConv(8, downsample=False, dropout=0.5)
    port = ph._MBConv(8, 8, False, dropout=0.5)
    v = _carry(jmod, port, x)
    draws = []
    uniform = jax.random.uniform

    def recording(*args, **kwargs):
        draws.append(uniform(*args, **kwargs))
        return draws[-1]

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        monkeypatch.setattr(jax.random, "uniform", recording)
        want, _ = jmod.apply(v64, jnp.asarray(x, jnp.float64), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(3)})
        monkeypatch.setattr(jax.random, "uniform", uniform)
        keep = np.asarray(draws[0]).reshape(-1) > 0.5
    assert len(draws) == 1 and keep.any() and not keep.all()
    port.dropsample.keep = lambda rows, device: torch.from_numpy(keep)
    seed_dropout(port, torch.Generator())
    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    _close(got, want, "MBConv dropsample", 1e-6)
