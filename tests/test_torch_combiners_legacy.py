"""The port's legacy pyramid combiners and the 2D PatchGAN
discriminator against the JAX package's, on the CPU in f64.

Each port module draws its weights (flax's law; every 1-D parameter moved
off its init), is carried to JAX with ``utils/convert.py``
(``jax_tree_from_state_dict``: the tree JAX's ``init`` builds, names and
shapes), and both run the same numpy skips, both sides in f64: in f32 the
GroupNorms of the pyramid's last, small maps cost digits on both sides
(JAX's own f32 output lies 1.7e-5 from its f64 one at
``CombineClassifier3``), which would hide a norm's eps (1e-6 against
torch's 1e-5 moves a unit-variance map by ~5e-6).  Tolerance: 1e-6
relative to max(1, max |JAX|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import combiners as jax_comb
from gfe_mamba_tpu.models.discriminator import \
    PatchDiscriminator as JaxPatchDiscriminator
from gfe_mamba_torch.models import combiners
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.utils.convert import jax_tree_from_state_dict
from gfe_mamba_torch.utils.initializers import init_weights

torch.set_num_threads(2)
REL = 1e-6
SPATIAL = (64, 72, 64)


def _close(got, want, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


def _params(port, jmod, *args, draw=True):
    """The port's weights (drawn unless ``draw`` is off), the port moved
    to f64, as the JAX params in f64, after checking their tree against
    JAX's ``init``; call under ``jax.enable_x64``."""
    if draw:
        gen = torch.Generator().manual_seed(0)
        init_weights(port, gen, "flax")
        with torch.no_grad():
            for p in port.parameters():
                if p.dim() == 1:
                    p.add_(0.2 * torch.randn(p.shape, generator=gen))
    port.double()
    params = jax_tree_from_state_dict(port.state_dict())
    like = jax.eval_shape(jmod.init, jax.random.key(0), *args)["params"]
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(like)
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(like)):
        assert got.shape == want.shape
    # ``convert`` gives f32 arrays: the f32 draws, which f64 holds exactly
    return {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), params)}


def _skips(batch=1, seed=0):
    rng = np.random.RandomState(seed)
    half = tuple(n // 2 for n in SPATIAL)
    enc = [rng.randn(batch, *SPATIAL, 8), rng.randn(batch, *half, 16)]
    dec = [rng.randn(batch, *SPATIAL, 8), rng.randn(batch, *half, 16)]
    return enc, dec


def _run(port, jmod, *args):
    """``port`` and ``jmod`` on the same weights and f64 inputs, in
    f64."""
    with jax.enable_x64(True):
        jargs = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
        variables = _params(port, jmod, *jargs)
        want = jax.jit(jmod.apply)(variables, *jargs)
        assert all(a.dtype == jnp.float64
                   for a in jax.tree_util.tree_leaves(want))
        want = jax.tree_util.tree_map(np.asarray, want)
    with torch.no_grad():
        got = port(*[jax.tree_util.tree_map(torch.from_numpy, a)
                     for a in args])
    return got, want


@pytest.mark.parametrize("name", ["CombineClassifier", "CombineClassifier2",
                                  "CombineClassifier3",
                                  "CombineClassifierCross",
                                  "CombineClassifierEmb"])
def test_legacy_combiner_matches_jax(name):
    enc, dec = _skips(batch=2)
    kw = {"CombineClassifierEmb": dict(patch_size=8, embed_dim=32)}.get(
        name, {})
    jmod = getattr(jax_comb, name)(latent_dim=4, **kw)
    extra = dict(spatial=SPATIAL) if name == "CombineClassifier" else {}
    port = getattr(combiners, name)(latent_dim=4, in_channels=(16, 32),
                                    **kw, **extra).eval()
    got, want = _run(port, jmod, enc, dec)
    _close(got, want, name)


def test_fused_combiner_matches_jax():
    enc, dec = _skips(seed=1)
    ft = np.random.RandomState(2).randn(1, 2, 4)
    jmod = jax_comb.CombineClassifierFused(latent_dim=4)
    port = combiners.CombineClassifierFused(4, (16, 32), SPATIAL,
                                            ft_tokens=2).eval()
    got, want = _run(port, jmod, enc, dec, ft)
    _close(got, want, "fused")


def test_strided_conv_orders_and_patch_embed_match_jax():
    x = np.random.RandomState(3).randn(2, 11, 9, 7, 12)
    for order, stride, groups in (("cge", 2, 8), ("gcr", 1, 4),
                                  ("cl", 3, 8)):
        jmod = jax_comb.StridedConv(16, 3, order, groups, 1, stride)
        port = combiners.StridedConv(12, 16, 3, order, groups, 1, stride)
        got, want = _run(port, jmod, x)
        _close(got, want, order)
    # 'SAME' padding where the extents are not multiples of the patch
    jmod = jax_comb.PatchEmbed3D(patch_size=4, dim=8)
    got, want = _run(combiners.PatchEmbed3D(12, 4, 8), jmod, x)
    _close(got, want, "PatchEmbed3D")


def test_pool_refuses_inputs_below_its_window():
    enc, dec = _skips()
    enc = [enc[0][:, :40, :40, :40], enc[1][:, :20, :20, :20]]
    dec = [dec[0][:, :40, :40, :40], dec[1][:, :20, :20, :20]]
    port = combiners.CombinePyramid(latent_dim=4, in_channels=(16, 32))
    with pytest.raises(ValueError, match="exceeds spatial dims"):
        port([torch.from_numpy(a).float() for a in enc],
             [torch.from_numpy(a).float() for a in dec])
    assert combiners.CombinePyramid is combiners.CombineClassifier3


@pytest.mark.parametrize("shape", [(2, 40, 36, 1), (1, 9, 6, 2)])
def test_patch_discriminator_2d_matches_jax(shape):
    """dims=2 through the kernel, the strides, the widened padding on
    small maps and the instance norms; every feature compared."""
    x = np.random.RandomState(4).randn(*shape)
    jmod = JaxPatchDiscriminator(num_layers_d=3, num_channels=4, dims=2)
    port = PatchDiscriminator(3, 4, in_channels=shape[-1], dims=2)
    port.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in port.parameters():
            if p.dim() == 1:
                p.add_(0.1)
    with jax.enable_x64(True):
        variables = _params(port, jmod, jnp.asarray(x), draw=False)
        want = [np.asarray(w) for w in
                jax.jit(jmod.apply)(variables, jnp.asarray(x))]
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    assert all(w.dtype == np.float64 for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"feature {i}")
    with pytest.raises(ValueError, match="dims"):
        PatchDiscriminator(dims=1)
