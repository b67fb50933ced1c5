"""The port's ``group_norm_act`` (``gfe_mamba_torch/ops/group_norm.py``,
K5a and K5b's plain versions on the CPU) against the JAX package's (its
Pallas kernels in interpret mode on the CPU), on the same numpy inputs.

Tolerances: f32 forward, max |port - JAX| <= 1e-5 (one-pass statistics on
both sides, summed in other orders); gradients in x, scale and bias
<= 1e-4 against ``jax.grad`` (both are the VJP of the two-pass reference);
bf16 forward within one bf16 ulp of JAX's, at the magnitude of the larger
of the two values (both round the same f32 result once, except where it
sits within f32 rounding of a tie), plus the f32 forward's 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.ops.pallas.group_norm import \
    group_norm_act as jax_group_norm_act
from gfe_mamba_torch.ops.cuda import group_norm as k5
from gfe_mamba_torch.ops.group_norm import group_norm_act

torch.set_num_threads(2)

# (shape, groups): the JAX kernel test's shape, and a ragged one (C = 12,
# S = 105, neither a multiple of a 16-byte vector or of the chunk)
SHAPES = {"aligned": ((2, 11, 7, 3, 16), 4), "ragged": ((2, 7, 5, 3, 12), 3)}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32))


def _jax(x, scale, bias, groups, act):
    return jax_group_norm_act(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), num_groups=groups, act=act,
                              chunk=64)


@pytest.mark.parametrize("case,act", [
    ("aligned", "none"), ("aligned", "elu"), ("aligned", "relu"),
    ("aligned", "leaky_relu"), ("aligned", "gelu"), ("ragged", "elu")])
def test_forward_matches_jax(case, act):
    """f32; an unknown act ('gelu') is the identity on both sides."""
    shape, groups = SHAPES[case]
    x, scale, bias = _inputs(shape)
    want = np.asarray(_jax(x, scale, bias, groups, act))
    got = group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias), num_groups=groups, act=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("act", ["elu", "relu"])
def test_gradients_match_jax(act):
    shape, groups = SHAPES["aligned"]
    x, scale, bias = _inputs(shape, seed=1)
    g = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(_jax(*a, groups, act) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, scale, bias)]
    y = group_norm_act(*ins, num_groups=groups, act=act)
    (y * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip(("x", "scale", "bias"), ins, want):
        assert np.abs(t.grad.numpy() - np.asarray(w)).max() <= 1e-4, name


def test_bf16_forward_within_one_ulp_of_jax():
    shape, groups = SHAPES["aligned"]
    x, scale, bias = _inputs(shape, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(jax_group_norm_act(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(bias), num_groups=groups,
        act="elu", chunk=64).astype(jnp.float32))
    got = group_norm_act(xb, torch.from_numpy(scale), torch.from_numpy(bias),
                         num_groups=groups, act="elu")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    c = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k5.group_norm_sums_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        k5.group_norm_apply_cuda(x, c, c, c[0], c[0])
