"""The port's ResNet3D and MVCSNet baselines against the JAX package's,
on the CPU at tiny widths.

Each port model draws flax-law weights (every 1-D parameter and
BatchNorm statistic moved off its init), is carried to JAX with
``utils/convert.py`` (``jax_variables_from_state_dict``: the tree JAX's
``init`` builds, and back bitwise), and both run the same numpy input.
Tolerance: 1e-5 relative to max(1, max |JAX|), for outputs and for the
BatchNorm statistics a train-mode forward moves; JAX runs at matmul
precision 'highest' (``tests/conftest.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import mvcs as jax_mvcs
from gfe_mamba_tpu.models import resnet3d as jax_resnet
from gfe_mamba_torch.models import mvcs, resnet3d
from gfe_mamba_torch.utils.convert import (jax_variables_from_state_dict,
                                           state_dict_from_jax)
from gfe_mamba_torch.utils.initializers import init_weights

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


def _variables(port, jmod, x, seed=0):
    """Flax-law weights drawn in the port, every 1-D parameter and
    running statistic moved off its init; returns the JAX variables of
    the same weights, after checking that their tree is the one JAX's
    ``init`` builds (names and shapes) and that the conversion back is
    bitwise."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(port, gen, "flax")
    with torch.no_grad():
        for p in port.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
        for name, b in port.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    variables = jax_variables_from_state_dict(port.state_dict())
    like = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(like)
    for got, want in zip(jax.tree_util.tree_leaves(variables),
                         jax.tree_util.tree_leaves(like)):
        assert got.shape == want.shape
    back = state_dict_from_jax(variables)
    state = port.state_dict()
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    return jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.mark.parametrize("depth", [10, 50])
def test_resnet3d_matches_jax(depth):
    """Eval mode in f32; train mode (batch statistics, and the running
    statistics it moves) in f64 on both sides: a train-mode BatchNorm
    over the few voxels of the last stages amplifies f32 rounding (at
    depth 50 JAX's own f32 output lies 1.2e-4 from its f64 one), so in
    f32 the comparison would measure rounding, not the function."""
    kw = dict(block_inplanes=(4, 8, 8, 16), n_classes=3,
              n_input_channels=1, conv1_t_size=5)
    jmod = jax_resnet.generate_model(depth, **kw)
    x = np.random.RandomState(depth).randn(2, 20, 16, 12, 1).astype(
        np.float32)
    port = resnet3d.generate_model(depth, **kw).eval()
    variables = _variables(port, jmod, x, depth)

    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(variables, jnp.asarray(x)),
               f"eval {depth}")

    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        out, moved = jax.jit(partial(jmod.apply, train=True,
                                     mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
        assert out.dtype == jnp.float64
        out, moved = np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                             moved)
    _close(got, out, f"train {depth}")
    stats = state_dict_from_jax({"params": {}, **moved})
    before = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        variables))
    state = port.state_dict()
    assert stats and set(stats) <= set(state)
    for key, value in stats.items():
        assert not torch.equal(value, before[key]), key
        _close(state[key], value.numpy(), key)


def test_resnet3d_options_match_jax():
    """``feature_only``, ``no_max_pool`` and ``widen_factor`` with a
    temporal stride on the stem."""
    kw = dict(block_inplanes=(4, 8, 8, 8), n_input_channels=2,
              conv1_t_size=3, conv1_t_stride=2, no_max_pool=True,
              widen_factor=1.5, feature_only=True)
    jmod = jax_resnet.generate_model(18, **kw)
    x = np.random.RandomState(0).randn(1, 12, 12, 10, 2).astype(np.float32)
    port = resnet3d.generate_model(18, **kw).eval()
    variables = _variables(port, jmod, x, 1)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 12)
    _close(got, jax.jit(jmod.apply)(variables, jnp.asarray(x)), "options")


def test_resnet3d_refuses_an_unknown_depth():
    with pytest.raises(ValueError, match="model_depth"):
        resnet3d.generate_model(42)
    with pytest.raises(ValueError, match="model_depth"):
        jax_resnet.generate_model(42)


def test_mvcsnet_matches_jax():
    jmod = jax_mvcs.MVCSNet(num_classes=2, base_channel=4)
    x = np.random.RandomState(5).randn(2, 16, 24, 32, 1).astype(np.float32)
    port = mvcs.MVCSNet(num_classes=2, base_channel=4).eval()
    variables = _variables(port, jmod, x, 5)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, jax.jit(jmod.apply)(variables, jnp.asarray(x)), "MVCSNet")

    # one SSA and one SADA block on their own, at a non-cubic volume
    sada = jax_mvcs.SADAAttention(heads=2)
    y = np.random.RandomState(7).randn(1, 5, 6, 4, 8).astype(np.float32)
    port_sada = mvcs.SADAAttention(8, heads=2).eval()
    sv = _variables(port_sada, sada, y, 7)
    with torch.no_grad():
        _close(port_sada(torch.from_numpy(y)),
               jax.jit(sada.apply)(sv, jnp.asarray(y)), "SADA")
