"""The port's ``models/vit_zoo_extra.py`` against the JAX package's, on the
CPU at tiny widths.

Each JAX model is initialized, every variable moved off its init, carried
to the port by ``state_dict_from_jax(variables, model)`` and loaded
strictly; both run the same numpy input.  Eval outputs agree within 1e-5
relative to max(1, max |JAX|) in f32.  Train mode runs with the draws
shared: CCT's stochastic depth takes the keep masks JAX's own
``bernoulli`` gives from the keys its ``_drop_path`` asks for, MPP the
noise, indices and coins of JAX's calls from its ``'mpp'`` key; the
port's draws are held to their laws separately.  MobileViT's train-mode
BatchNorms over a few values amplify f32 rounding, so that comparison
runs in f64 on both sides at 1e-6, as ``test_torch_resnet3d_mvcs.py``
does.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo_extra as jx
from gfe_mamba_torch.models import vit_zoo_extra as px
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


def _carry(jmod, port, x, seed=0, rngs=None):
    """JAX variables from ``init`` with every leaf moved off its init
    (running variances kept positive), loaded into ``port``."""
    rngs = {"params": jax.random.key(seed), **(rngs or {})}
    variables = jax.jit(jmod.init)(rngs, jnp.asarray(x))
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


def _eval_close(jmod, port, x, tag, seed=0):
    v = _carry(jmod, port.eval(), x, seed)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, jax.jit(jmod.apply)(v, jnp.asarray(x)), tag)


def _img(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_tables_match_jax():
    """The 3D sincos table (dim not divisible by 6: zero-padded) and
    CCT's sine table."""
    _close(px._posemb_sincos_3d(2, 3, 4, 20), jx._posemb_sincos_3d(2, 3, 4,
                                                                   20))
    _close(px._sinusoidal_embedding(7, 10),
           jx._sinusoidal_embedding(7, 10))


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (4, 2, 0), (7, 4, 2)])
def test_unfold2d_matches_jax_and_unfold(k, stride, pad):
    """Channel-major features, as ``F.unfold`` gives them."""
    x = _img(0, 2, 11, 9, 3)
    _close(px._unfold2d(torch.from_numpy(x), k, stride, pad),
           jx._unfold2d(jnp.asarray(x), k, stride, pad))


def test_simple_vit3d_matches_jax():
    kw = dict(image_size=(8, 16, 12), patch_size=(4, 8, 4), num_classes=3,
              dim=32, depth=2, heads=2, mlp_dim=40, dim_head=16)
    _eval_close(jx.SimpleViT3D(**kw), px.SimpleViT3D(**kw, channels=2),
                _img(1, 2, 8, 16, 12, 2), "SimpleViT3D")


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vivit_matches_jax(pool):
    kw = dict(image_size=(16, 16), image_patch_size=(8, 8), frames=8,
              frame_patch_size=4, num_classes=3, dim=32, spatial_depth=1,
              temporal_depth=2, heads=2, mlp_dim=32, dim_head=16, pool=pool)
    _eval_close(jx.ViViT(**kw), px.ViViT(**kw, channels=2),
                _img(2, 2, 8, 16, 16, 2), f"ViViT {pool}")


CCT_CASES = {
    "learnable": dict(positional_embedding="learnable"),
    "sine+class_token": dict(positional_embedding="sine", seq_pool=False),
    "none": dict(positional_embedding="none"),
}


@pytest.mark.parametrize("case", sorted(CCT_CASES))
def test_cct_matches_jax(case):
    kw = dict(num_classes=4, embedding_dim=16, num_layers=2, num_heads=2,
              **CCT_CASES[case])
    _eval_close(jx.CCT(**kw), px.CCT(**kw, image_size=32, channels=3),
                _img(3, 2, 32, 32, 3), f"CCT {case}")


def test_cct3d_matches_jax():
    kw = dict(num_classes=3, embedding_dim=16, num_layers=2, num_heads=2)
    _eval_close(jx.CCT3D(**kw),
                px.CCT3D(**kw, image_size=16, frames=8, channels=1),
                _img(4, 2, 8, 16, 16, 1), "CCT3D")


def test_cct_stochastic_depth_matches_jax(monkeypatch):
    """Train mode with stochastic depth 0.5 (attention and plain dropout
    off): the keep masks are the ``bernoulli`` draws of the keys JAX's
    ``_drop_path`` takes, handed to each port ``DropPath`` in order."""
    kw = dict(num_classes=4, embedding_dim=16, num_layers=3, num_heads=2,
              stochastic_depth=0.5, attention_dropout=0.0)
    x = _img(5, 4, 32, 32, 3)
    jmod = jx.CCT(**kw)
    port = px.CCT(**kw, image_size=32).train()
    v = _carry(jmod, port, x)
    keys = []
    drop_path = jx._drop_path

    class Recorder:
        def __init__(self, mod):
            self.mod = mod

        def make_rng(self, name):
            keys.append(self.mod.make_rng(name))
            return keys[-1]

    monkeypatch.setattr(jx, "_drop_path", lambda h, rate, det, mod, name:
                        drop_path(h, rate, det, Recorder(mod), name))
    want = jmod.apply(v, jnp.asarray(x), deterministic=False,
                      rngs={"dropout": jax.random.key(9)})
    rates = [float(r) for r in np.linspace(0, 0.5, 3) if r > 0]
    masks = [np.asarray(jax.random.bernoulli(k, 1.0 - r, (4, 1, 1)))
             .reshape(4) for k, r in zip(keys, np.repeat(rates, 2))]
    assert len(masks) == 4 and any(not m.all() for m in masks)
    paths = [m for m in port.modules() if isinstance(m, px.DropPath)
             and m.p > 0]
    assert len(paths) == 4
    for mod, mask in zip(paths, masks):
        mod.keep = (lambda m: lambda rows, device: torch.tensor(m))(mask)
    seed_dropout(port, torch.Generator())
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, "CCT train")


def test_drop_path_law():
    """Kept with probability 1 - p per sample, scaled by 1 / (1 - p),
    reproducible from the generator's seed; the identity in eval mode."""
    mod = px.DropPath(0.3)
    seed_dropout(mod, torch.Generator().manual_seed(0))
    out = mod(torch.ones(20000, 2, 3))
    kept = out[:, 0, 0] > 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.7))
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    assert abs(kept.double().mean().item() - 0.7) < 0.015
    assert torch.equal(mod.eval()(out), out)


MODELS = {
    "CaiT": (dict(image_size=16, patch_size=4, num_classes=3, dim=16,
                  depth=2, cls_depth=2, heads=2, mlp_dim=24, dim_head=8),
             (2, 16, 16, 3), {}),
    "DeepViT-cls": (dict(image_size=16, patch_size=4, num_classes=3, dim=16,
                         depth=2, heads=2, mlp_dim=24, dim_head=8),
                    (2, 16, 16, 3), {}),
    "DeepViT-mean": (dict(image_size=16, patch_size=4, num_classes=3,
                          dim=16, depth=2, heads=2, mlp_dim=24, dim_head=8,
                          pool="mean"), (2, 16, 16, 3), {}),
    "PiT": (dict(image_size=16, patch_size=4, num_classes=3, dim=8,
                 depth=(1, 2), heads=(2, 2), mlp_dim=16, dim_head=8),
            (2, 16, 16, 3), {}),
    "T2TViT": (dict(image_size=16, num_classes=3, dim=16, depth=1, heads=2,
                    mlp_dim=24, dim_head=8, t2t_layers=((3, 2), (3, 2))),
               (2, 16, 16, 1), dict(channels=1)),
    "T2TViT-default-layers": (dict(image_size=32, num_classes=3, dim=16,
                                   depth=1, heads=2, mlp_dim=24, dim_head=8,
                                   pool="mean"),
                              (1, 32, 32, 1), dict(channels=1)),
    "CrossViT": (dict(image_size=16, num_classes=3, sm_patch_size=4,
                      lg_patch_size=8, sm_dim=16, lg_dim=24, heads=2,
                      dim_head=8), (2, 16, 16, 3), {}),
    "CvT": (dict(num_classes=3, emb_dims=(8, 16, 24), heads=(1, 2, 3),
                 depths=(1, 2, 1), dim_head=8), (2, 32, 32, 3), {}),
    "NesT": (dict(image_size=16, patch_size=2, num_classes=3, dim=8,
                  heads=2, num_hierarchies=3, block_repeats=(1, 1, 2)),
             (2, 16, 16, 3), {}),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    kw, shape, extra = MODELS[name]
    cls = name.split("-")[0]
    _eval_close(getattr(jx, cls)(**kw), getattr(px, cls)(**kw, **extra),
                _img(len(name), *shape), name)


MOBILE = dict(image_size=(64, 64), dims=(8, 8, 16),
              channels=(4, 4, 8, 8, 8, 8, 8, 8, 8, 8, 16), num_classes=3,
              depths=(1, 1, 1))


def test_mobilevit_matches_jax():
    """Eval in f32; train mode (batch statistics, and the running
    statistics it moves) in f64 on both sides."""
    x = _img(6, 2, 64, 64, 3)
    jmod = jx.MobileViT(**MOBILE)
    port = px.MobileViT(**MOBILE).eval()
    v = _carry(jmod, port, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jax.jit(jmod.apply)(
            v, jnp.asarray(x)), "eval")
    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        out, moved = jax.jit(partial(jmod.apply, train=True,
                                     mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
        assert out.dtype == jnp.float64
        out, moved = np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                             moved)
    _close(got, out, "train", 1e-6)
    after = state_dict_from_jax({"params": v["params"], **moved}, port)
    state = port.state_dict()
    for key in state:
        if key.endswith(("running_mean", "running_var")):
            _close(state[key], after[key].numpy(), key, 1e-6)


MPP_KW = dict(image_size=16, patch_size=4, dim=16, depth=2, heads=2,
              mlp_dim=24, channels=3, dim_head=8, mask_prob=0.3,
              replace_prob=0.5, random_patch_prob=0.3)


def test_mpp_loss_and_gradients_match_jax():
    """The loss and every gradient with JAX's draws (from the key its
    ``make_rng('mpp')`` gives) handed to the port's ``MPP.draws``."""
    x = _img(7, 3, 16, 16, 3)
    jmod = jx.MPP(**MPP_KW)
    port = px.MPP(**MPP_KW)
    rngs = {"mpp": jax.random.key(11)}
    v = _carry(jmod, port, x, rngs=rngs)
    rng = jmod.apply(v, rngs=rngs, method=lambda m: m.make_rng("mpp"))
    k_noise, k_rand, k_coin1, k_coin2 = jax.random.split(rng, 4)
    b, n = 3, 16
    draws = (jax.random.uniform(k_noise, (b, n)),
             jax.random.randint(k_rand, (b, n), 0, n),
             jax.random.uniform(k_coin1, (b, n)),
             jax.random.uniform(k_coin2, (b, n)))
    port.draws = lambda *a: tuple(torch.from_numpy(
        np.array(d, np.int64 if d.dtype == jnp.int32 else np.float32))
        for d in draws)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply({"params": p}, jnp.asarray(x), rngs=rngs)))(
        v["params"])
    got = port(torch.from_numpy(x), torch.Generator())
    _close(got, loss, "loss")
    got.backward()
    want = state_dict_from_jax(grads, port)
    for key, p in port.named_parameters():
        _close(p.grad, want[key].numpy(), key)


def test_mpp_draws_law():
    """Uniforms in [0, 1), indices uniform over the patches, reproducible
    from the generator's seed."""
    a = px.MPP.draws(500, 40, torch.Generator().manual_seed(1), "cpu")
    b = px.MPP.draws(500, 40, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    noise, idx, u1, u2 = a
    for u in (noise, u1, u2):
        assert u.min() >= 0 and u.max() < 1
        assert abs(u.mean().item() - 0.5) < 0.01
    freq = torch.bincount(idx.flatten(), minlength=40).double() / idx.numel()
    assert idx.min() >= 0 and idx.max() < 40
    assert (freq - 1 / 40).abs().max() < 0.006
