"""The port's conv ops (``gfe_mamba_torch/ops/conv3d.py``, K1's plain
version) against the JAX package's on the same numpy inputs, in f32.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|); both sides sum
27*C products in f32 in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from gfe_mamba_tpu.ops.pallas.conv3d import (_conv3x3x3_fused_p,
                                             conv3x3x3_p,
                                             deconv3x3x3_s2_packed)
from gfe_mamba_tpu.ops.pallas.conv3d import \
    group_norm_stats as jax_group_norm_stats
from gfe_mamba_tpu.ops.pallas.conv3d import pack_z, unpack_z
from gfe_mamba_tpu.utils.torch_import import _deconv
from gfe_mamba_torch.ops import conv3d as port
from gfe_mamba_torch.ops.cuda import conv3d as k1

torch.set_num_threads(2)

REL = 1e-4


def _assert_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _inputs(seed, shape=(2, 6, 5, 8), C=8, F=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, F) / np.sqrt(27 * C)).astype(np.float32)
    bias = rng.randn(F).astype(np.float32)
    a = (np.abs(rng.randn(shape[0], C)) + 0.5).astype(np.float32)
    s = rng.randn(shape[0], C).astype(np.float32)
    res = rng.randn(*shape, F).astype(np.float32)
    return x, w, bias, a, s, res


T = torch.from_numpy


@pytest.mark.parametrize("act,with_res,post_act,affine", [
    ("relu", False, "none", True),
    ("elu", False, "none", False),
    ("leaky001", False, "none", True),
    ("none", True, "relu", True),
    ("none", True, "leaky01", False),
])
def test_conv_matches_conv3x3x3_p(act, with_res, post_act, affine):
    x, w, bias, a, s, res = _inputs(0)
    if not affine:
        a = s = None
    res = res if with_res else None
    want = unpack_z(conv3x3x3_p(
        pack_z(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(bias),
        None if a is None else jnp.asarray(a),
        None if s is None else jnp.asarray(s),
        None if res is None else pack_z(jnp.asarray(res)), act, post_act))
    got = port.conv3x3x3(T(x), T(w), T(bias),
                         None if a is None else T(a),
                         None if s is None else T(s),
                         None if res is None else T(res), act, post_act)
    _assert_close(got, want)


@pytest.mark.parametrize("act,with_res,post_act", [
    ("relu", False, "none"),
    ("none", True, "elu"),
])
def test_conv_matches_pallas_kernel_interpret(act, with_res, post_act):
    """K1's plain version against the Pallas kernel itself, run in
    interpret mode at a tiny shape."""
    x, w, bias, a, s, res = _inputs(1, shape=(1, 8, 8, 8), C=64, F=64)
    res = res if with_res else None
    want = unpack_z(_conv3x3x3_fused_p(
        pack_z(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(a), jnp.asarray(s),
        None if res is None else pack_z(jnp.asarray(res)),
        act=act, post_act=post_act, xt=4, yt=4, interpret=True))
    got = port.conv3x3x3(T(x), T(w), T(bias), T(a), T(s),
                         None if res is None else T(res), act, post_act)
    _assert_close(got, want)


def test_conv_rejects_act_with_epilogue():
    x, w, _, _, _, res = _inputs(2)
    with pytest.raises(ValueError):
        port.conv3x3x3(T(x), T(w), None, None, None, T(res), "relu", "relu")


def test_conv_kernel_wrapper_refuses_cpu_tensors():
    x, w, *_ = _inputs(3)
    with pytest.raises(ValueError):
        k1.conv3x3x3_cuda(T(x), T(w))


@pytest.mark.parametrize("C,groups", [(16, 8), (4, 1)])
def test_group_norm_stats(C, groups):
    x = np.random.RandomState(4).randn(2, 6, 5, 4, C).astype(np.float32)
    mu_j, rstd_j = jax_group_norm_stats(jnp.asarray(x), groups, eps=1e-5)
    mu_t, rstd_t = port.group_norm_stats(T(x), groups, eps=1e-5)
    _assert_close(mu_t, mu_j)
    _assert_close(rstd_t, rstd_j)


def test_max_pool():
    x = np.random.RandomState(5).randn(2, 6, 4, 8, 3).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (2, 2, 2), strides=(2, 2, 2))
    _assert_close(port.pool_nd(T(x), "max", 2), want, rel=0.0)


def test_deconv_emits_2n_like_the_octant_deconv():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 4, 8).astype(np.float32)
    w_torch = (rng.randn(8, 4, 3, 3, 3) / 15).astype(np.float32)
    want = unpack_z(deconv3x3x3_s2_packed(pack_z(jnp.asarray(x)),
                                          jnp.asarray(_deconv(w_torch))))
    got = port.deconv3x3x3_s2(T(x), T(w_torch))
    assert got.shape == (2, 6, 8, 8, 4)
    _assert_close(got, want)
