"""The port's ``models/vit_zoo_simple.py`` against the JAX package's, on
the CPU at tiny widths.

Each JAX model is initialized, every parameter moved off its init,
carried to the port by ``state_dict_from_jax(variables, model)`` and
loaded strictly; both run the same numpy input; outputs agree within 1e-5
relative to max(1, max |JAX|) in f32.  Patch dropout's train mode takes
the scores JAX's own ``normal`` draws from the key its
``make_rng('dropout')`` gives; the port's draw is held to its law
separately.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo_simple as js
from gfe_mamba_tpu.models.vit import ViTTransformer
from gfe_mamba_torch.models import vit_zoo_simple as ps
from gfe_mamba_torch.models.dropout import seed_dropout
from gfe_mamba_torch.models.vit import Transformer
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


def _carry(jmod, port, x, seed=0):
    variables = jax.jit(jmod.init)(jax.random.key(seed), jnp.asarray(x))
    rng = np.random.RandomState(seed + 1)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), variables)
    port.load_state_dict(state_dict_from_jax(variables, port))
    return variables


def _img(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


IMG = dict(image_size=16, patch_size=4, num_classes=3, dim=16, depth=2,
           heads=2, mlp_dim=24, dim_head=8)
SERIES = dict(seq_len=24, patch_size=4, num_classes=3, dim=16, depth=2,
              heads=2, mlp_dim=24, dim_head=8)

# name -> (class, JAX fields, port keywords, input shape)
MODELS = {
    "SimpleViT1D": ("SimpleViT1D", SERIES, dict(channels=2), (2, 24, 2)),
    "ViT1D": ("ViT1D", SERIES, dict(channels=2), (2, 24, 2)),
    "SimpleViTPatchDropout": ("SimpleViTPatchDropout", IMG, {},
                              (2, 16, 16, 3)),
    "ViTPatchDropout-cls": ("ViTPatchDropout", IMG, {}, (2, 16, 16, 3)),
    "ViTPatchDropout-mean": ("ViTPatchDropout", dict(IMG, pool="mean"), {},
                             (2, 16, 16, 3)),
    "SimpleViTQKNorm": ("SimpleViTQKNorm", IMG, {}, (2, 16, 16, 3)),
    "SimpleViTRegisterTokens": ("SimpleViTRegisterTokens",
                                dict(IMG, num_register_tokens=3), {},
                                (2, 16, 16, 3)),
    "SimpleViTFFT": ("SimpleViTFFT",
                     dict(IMG, image_size=(16, 12), freq_patch_size=(2, 4)),
                     dict(channels=2), (2, 16, 12, 2)),
    "ViTWithPatchMerger": ("ViTWithPatchMerger",
                           dict(IMG, depth=3, patch_merge_num_tokens=5), {},
                           (2, 16, 16, 3)),
    "ViTWithPatchMerger-layer": ("ViTWithPatchMerger",
                                 dict(IMG, depth=3, patch_merge_layer=3),
                                 {}, (2, 16, 16, 3)),
    "ViTForSmallDataset": ("ViTForSmallDataset", IMG, {}, (2, 16, 16, 3)),
    "ParallelViT": ("ParallelViT", dict(IMG, num_parallel_branches=3), {},
                    (2, 16, 16, 3)),
    "ParallelViT-mean": ("ParallelViT", dict(IMG, pool="mean"), {},
                         (2, 16, 16, 3)),
    "LocalViT": ("LocalViT", IMG, {}, (2, 16, 16, 3)),
    "SimpleFlashAttnViT": ("SimpleFlashAttnViT", IMG, {}, (2, 16, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    cls, kw, extra, shape = MODELS[name]
    x = _img(len(name), *shape)
    jmod = getattr(js, cls)(**kw)
    port = getattr(ps, cls)(**kw, **extra).eval()
    v = _carry(jmod, port, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)), name)


def test_posemb_sincos_1d_matches_jax():
    _close(ps._posemb_sincos_1d(9, 12), js._posemb_sincos_1d(9, 12))


def test_patch_merger_matches_jax():
    x = np.random.RandomState(0).randn(2, 7, 16).astype(np.float32)
    jmod, port = js.PatchMerger(16, 3), ps.PatchMerger(16, 3)
    v = _carry(jmod, port, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jmod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_efficient_vit_matches_jax(pool):
    """The port's ``Transformer`` as the backbone where JAX has its
    ``ViTTransformer``."""
    kw = dict(image_size=(16, 12), patch_size=4, num_classes=3, dim=16,
              pool=pool)
    x = _img(1, 2, 16, 12, 1)
    jmod = js.EfficientViT(**kw, transformer=ViTTransformer(2, 2, 8, 24))
    port = ps.EfficientViT(**kw, transformer=Transformer(16, 2, 2, 8, 24),
                           channels=1).eval()
    v = _carry(jmod, port, x)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)), pool)


@pytest.mark.parametrize("cls", ["SimpleViTPatchDropout", "ViTPatchDropout"])
def test_patch_dropout_train_matches_jax(cls):
    """Train mode: the scores JAX draws from its ``'dropout'`` key handed
    to the port's ``PatchDropout.scores``."""
    kw = dict(IMG, patch_dropout=0.4)
    x = _img(2, 3, 16, 16, 3)
    jmod = getattr(js, cls)(**kw)
    port = getattr(ps, cls)(**kw).train()
    v = _carry(jmod, port, x)
    rngs = {"dropout": jax.random.key(5)}
    key = jmod.apply(v, rngs=rngs, method=lambda m: m.make_rng("dropout"))
    scores = np.asarray(jax.random.normal(key, (3, 16)))
    port.patch_dropout.scores = lambda rows, n, device: torch.tensor(scores)
    seed_dropout(port, torch.Generator())
    want = jax.jit(lambda v, x: jmod.apply(v, x, deterministic=False,
                                           rngs=rngs))(v, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, cls)


def test_patch_dropout_law():
    """max(1, int(n (1 - p))) distinct tokens kept per sample, each token
    near equally likely, reproducible from the generator's seed; the
    identity in eval mode."""
    mod = ps.PatchDropout(0.75)
    x = torch.arange(10.0)[None, :, None].expand(2000, 10, 1)
    out = []
    for _ in range(2):
        seed_dropout(mod, torch.Generator().manual_seed(0))
        out.append(mod(x))
    assert torch.equal(out[0], out[1]) and out[0].shape == (2000, 2, 1)
    kept = out[0][..., 0].long()
    assert (kept[:, 0] != kept[:, 1]).all()
    freq = torch.bincount(kept.flatten(), minlength=10).double() / 4000
    assert (freq - 0.1).abs().max() < 0.02, freq
    assert torch.equal(mod.eval()(x), x)
