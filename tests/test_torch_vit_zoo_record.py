"""The port's ``extract`` and ``record_attention``
(``models/vit_zoo_final.py``) against the JAX package's, on the CPU at
tiny widths, and the ``attend`` submodule they hook in
``models/vit.py::Attention``.

The JAX model is initialized, every variable moved off its init and
carried to the port by ``state_dict_from_jax``; outputs, latents and
attention maps agree within 1e-5 relative to max(1, max |JAX|) in f32,
and the maps stack in JAX's order (a depth of 11 puts ``layers.10`` after
``layers.9``, where a plain string sort would not).  Attaching the hooks
changes no output: the main path's modules (``ImageToImageViT`` and the
Stage-1 generator around it) give the same bits with and without them,
and ``Attention``'s state_dict keys are those it had before ``attend``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo as jz
from gfe_mamba_tpu.models import vit_zoo_final as jf
from gfe_mamba_torch.models import vit_zoo as pz
from gfe_mamba_torch.models import vit_zoo_final as pf
from gfe_mamba_torch.models.pipeline import build_generator
from gfe_mamba_torch.models.vit import Attention, ImageToImageViT
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag="", rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, (tag, err)


def _pair_of(name, x):
    """(JAX model, moved variables, the port model holding them)."""
    cls, kw = MODELS[name]
    jmod = getattr(jf if cls in ("DistillableViT", "MemoryViT", "RvT")
                   else jz, cls)(**kw)
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), variables)
    port = getattr(pf if cls in ("DistillableViT", "MemoryViT", "RvT")
                   else pz, cls)(**kw).eval()
    port.load_state_dict(state_dict_from_jax(variables, port))
    return jmod, variables, port


SMALL = dict(image_size=16, patch_size=4, num_classes=2, dim=32, heads=2,
             mlp_dim=48, dim_head=16)
MODELS = {
    "ClassifierViT": ("ClassifierViT", dict(SMALL, depth=2)),
    "ClassifierViT-deep": ("ClassifierViT", dict(SMALL, depth=11)),
    "DistillableViT": ("DistillableViT", dict(SMALL, depth=3)),
    "MemoryViT": ("MemoryViT", dict(SMALL, depth=2)),
    "RvT": ("RvT", dict(SMALL, depth=2)),
}


def _img(seed):
    return np.random.RandomState(seed).rand(2, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["ClassifierViT", "DistillableViT",
                                  "MemoryViT"])
def test_extract_matches_jax(name):
    """The transformer's output (a port ``Transformer`` for the first
    two, MemoryViT's own stack for the third) beside the logits."""
    x = _img(len(name))
    jmod, v, port = _pair_of(name, x)
    want, want_latent = jf.extract(jmod, v, jnp.asarray(x))
    with torch.no_grad():
        got, latent = pf.extract(port, torch.from_numpy(x))
        plain = port(torch.from_numpy(x))
    _close(got, want, f"{name} out")
    _close(latent, want_latent, f"{name} latent")
    assert torch.equal(got, plain)
    assert not port.transformer._forward_hooks


def test_extract_named_layer_and_missing_layer():
    x = _img(3)
    jmod, v, port = _pair_of("ClassifierViT", x)
    with torch.no_grad():
        _, latent = pf.extract(port, torch.from_numpy(x),
                               layer_name="mlp_head")
        assert torch.equal(latent, port(torch.from_numpy(x)))
        with pytest.raises(ValueError, match="not found"):
            pf.extract(port, torch.from_numpy(x), layer_name="nowhere")


@pytest.mark.parametrize("name", ["ClassifierViT", "ClassifierViT-deep",
                                  "DistillableViT"])
def test_record_attention_matches_jax(name):
    """(B, layers, heads, N, N) maps whose rows sum to 1, in JAX's
    order; the logits bit for bit those without the hooks."""
    x = _img(len(name) + 5)
    jmod, v, port = _pair_of(name, x)
    want, want_maps = jf.record_attention(jmod, v, jnp.asarray(x))
    with torch.no_grad():
        got, maps = pf.record_attention(port, torch.from_numpy(x))
        plain = port(torch.from_numpy(x))
    depth = MODELS[name][1]["depth"]
    assert maps.shape == (2, depth, 2, 17, 17)
    _close(got, want, f"{name} out")
    _close(maps, want_maps, f"{name} maps")
    _close(maps.sum(-1), np.ones(maps.shape[:-1], np.float32), "rows")
    assert torch.equal(got, plain)
    assert all(not m.attend._forward_hooks for m in port.modules()
               if isinstance(m, Attention))


def test_record_attention_none_without_vit_attention():
    """RvT has its own attention, which JAX does not sow (its
    ``record_attention`` then finds no ``intermediates`` collection at
    all and raises a KeyError); the port returns None, as both
    docstrings say."""
    x = _img(9)
    jmod, v, port = _pair_of("RvT", x)
    want, state = jmod.apply(v, jnp.asarray(x), mutable=["intermediates"])
    assert not state
    with torch.no_grad():
        got, maps = pf.record_attention(port, torch.from_numpy(x))
    assert maps is None
    _close(got, want, "RvT out")


def test_attention_state_dict_keys_unchanged():
    """``attend`` has no parameters: the keys every checkpoint and
    importer names stay as they were."""
    keys = set(Attention(16, 2, 8).state_dict())
    assert keys == {"norm.weight", "norm.bias", "to_qkv.weight",
                    "to_out.0.weight", "to_out.0.bias"}
    assert set(Attention(16, 1, 16).state_dict()) == {
        "norm.weight", "norm.bias", "to_qkv.weight"}


def test_main_path_outputs_bitwise_with_recorder():
    """The Stage-1 generator (its ImageToImageViT bottleneck included) and
    an ImageToImageViT alone: the same bits with and without recording,
    and one map per bottleneck layer."""
    gen = build_generator(img_size=(16, 16, 8), device="cpu", seed=0,
                          f_maps=(8, 16, 32), fold_factor=2,
                          vit_patch_size=4, vit_dim=16, vit_depth=2,
                          vit_heads=2, vit_mlp_dim=32).eval()
    vol = torch.from_numpy(np.random.RandomState(11).rand(
        2, 16, 16, 8, 1).astype(np.float32))
    with torch.no_grad():
        plain = gen(vol)
        recorded, maps = pf.record_attention(gen, vol)
    assert maps is not None and maps.shape[:2] == (2, 2)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (plain, recorded))):
        assert torch.equal(a, b)
    vit = ImageToImageViT((16, 24), 3, patch_size=4, dim=32, depth=3,
                          heads=2, mlp_dim=48, dim_head=16)
    pz.init_zoo(vit, torch.Generator().manual_seed(2))
    img = torch.from_numpy(np.random.RandomState(12).rand(
        2, 16, 24, 3).astype(np.float32))
    with torch.no_grad():
        plain = vit(img)
        recorded, maps = pf.record_attention(vit, img)
    assert torch.equal(plain, recorded) and maps.shape == (2, 3, 2, 25, 25)
