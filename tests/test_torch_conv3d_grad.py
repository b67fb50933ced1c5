"""The port's conv backward (``Conv3x3x3Fn``: K1 as the input gradient,
K3's plain version as the weight gradient) and the GroupNorm-statistics
gradient against JAX on the same numpy inputs, in f32.

Tolerances: max |port - JAX| <= 1e-4 * max(1, max |JAX|) per gradient
(27*C or volume-long f32 sums in different orders); the dw kernel's
plain version against the Pallas kernel in interpret mode 3e-4, the
JAX test's own tolerance for that kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.ops.blocks import ResNetBlock as JaxResNetBlock
from gfe_mamba_tpu.ops.pallas.conv3d import _dw_pallas_p, conv3x3x3_p
from gfe_mamba_tpu.ops.pallas.conv3d import \
    group_norm_stats as jax_group_norm_stats
from gfe_mamba_tpu.ops.pallas.conv3d import pack_z, unpack_z
from gfe_mamba_torch.ops import conv3d as port
from gfe_mamba_torch.ops.blocks import ResNetBlock
from gfe_mamba_torch.ops.cuda import conv3d as k1
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

REL = 1e-4
T = torch.from_numpy


def _assert_close(got, want, name="", rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (name, err)


def _inputs(seed, shape=(2, 6, 5, 8), C=8, F=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, C).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, F) / np.sqrt(27 * C)).astype(np.float32)
    bias = rng.randn(F).astype(np.float32)
    a = (np.abs(rng.randn(shape[0], C)) + 0.5).astype(np.float32)
    s = rng.randn(shape[0], C).astype(np.float32)
    res = rng.randn(*shape, F).astype(np.float32)
    g = rng.randn(*shape, F).astype(np.float32)
    return x, w, bias, a, s, res, g


# the two fused shapes of a ResNetBlock (conv2: GN+conv+act; conv3:
# GN+conv+residual+post_act), plus a conv with a bias (no GN) and elu
@pytest.mark.parametrize("act,with_res,post_act,with_bias", [
    ("relu", False, "none", False),
    ("none", True, "relu", False),
    ("elu", False, "none", True),
    ("none", True, "leaky01", True),
])
def test_conv_grads_match_jax_vjp(act, with_res, post_act, with_bias):
    x, w, bias, a, s, res, g = _inputs(0)
    bias = bias if with_bias else None
    res = res if with_res else None
    names = ["dx", "dw", "dbias", "da", "ds", "dres"]
    inputs = [x, w, bias, a, s, res]
    present = [i for i, v in enumerate(inputs) if v is not None]
    packed = {0, 5}              # x and the residual travel z-pair packed

    def f(*vals):
        full = list(inputs)
        for i, v in zip(present, vals):
            full[i] = v
        return conv3x3x3_p(*full, act, post_act)

    jin = [pack_z(jnp.asarray(inputs[i])) if i in packed
           else jnp.asarray(inputs[i]) for i in present]
    _, vjp = jax.vjp(f, *jin)
    want = dict(zip(present, vjp(pack_z(jnp.asarray(g)))))

    tin = [None if v is None else T(v).requires_grad_() for v in inputs]
    out = port.conv3x3x3(*tin, act, post_act)
    out.backward(T(g))
    for i in present:
        ref = unpack_z(want[i]) if i in packed else want[i]
        _assert_close(tin[i].grad, ref, names[i])


@pytest.mark.parametrize("order,c_in,c_out", [("gcr", 8, 16),
                                              ("gcr", 16, 16)])
def test_resnet_block_grads_match_jax(order, c_in, c_out):
    """Every parameter's and the input's gradient through a whole
    ResNetBlock: GN statistics (ordinary autograd, as XLA autodiff in
    JAX), the fused convs' backward and the residual path."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 8, c_in).astype(np.float32)
    g = rng.randn(2, 6, 5, 8, c_out).astype(np.float32)
    block = JaxResNetBlock(c_out, order=order)
    params = block.init(jax.random.key(0), jnp.asarray(x))

    def f(p, xin):
        return jnp.sum(block.apply(p, xin) * g)

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    port_block = ResNetBlock(c_in, c_out, order)
    port_block.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    xt = T(x).requires_grad_()
    (port_block(xt) * T(g)).sum().backward()
    _assert_close(xt.grad, gx, "x")
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    for name, p in port_block.named_parameters():
        _assert_close(p.grad, want[name], name)


def test_dw_plain_matches_pallas_kernel_interpret():
    """K3's plain version against the Pallas dw kernel run in interpret
    mode on z-pair-packed operands (a non-divisible spatial geometry)."""
    rng = np.random.RandomState(2)
    B, X, Y, ZH, C, F = 1, 6, 10, 5, 64, 64
    z = (0.1 * rng.randn(B, X, Y, ZH, 2 * C)).astype(np.float32)
    g1 = (0.1 * rng.randn(B, X, Y, ZH, 2 * F)).astype(np.float32)
    want = _dw_pallas_p(jnp.asarray(z), jnp.asarray(g1), xt=4, yt=8,
                        interpret=True)
    got = k1.conv3x3x3_dw_plain(T(np.array(unpack_z(jnp.asarray(z)))),
                                T(np.array(unpack_z(jnp.asarray(g1)))))
    _assert_close(got, want, "dw", rel=3e-4)


def test_dw_plain_applies_the_affine_to_real_voxels_only():
    x, _, _, a, s, _, g = _inputs(3, shape=(2, 4, 3, 5))
    got = k1.conv3x3x3_dw_plain(T(x), T(g), T(a), T(s))
    zhat = x * a[:, None, None, None] + s[:, None, None, None]
    zp = np.pad(zhat, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    want = np.stack([np.einsum("bxyzc,bxyzf->cf",
                               zp[:, i:i + 4, j:j + 3, k:k + 5], g)
                     for i in range(3) for j in range(3) for k in range(3)])
    _assert_close(got, want.reshape(3, 3, 3, 8, 16), "dw")


def test_group_norm_stats_grad_matches_jax():
    x = np.random.RandomState(4).randn(2, 6, 5, 4, 16).astype(np.float32)
    cot = np.random.RandomState(5).randn(2, 2, 16).astype(np.float32)

    def f(xin):
        mu, rstd = jax_group_norm_stats(xin, 8, eps=1e-5)
        return jnp.sum(mu * cot[0] + rstd * cot[1])

    want = jax.grad(f)(jnp.asarray(x))
    xt = T(x).requires_grad_()
    mu, rstd = port.group_norm_stats(xt, 8, eps=1e-5)
    (mu * T(cot[0]) + rstd * T(cot[1])).sum().backward()
    _assert_close(xt.grad, want, "dx")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_stats_grad_is_finite_on_a_zero_channel(dtype):
    """A dead relu channel (all zeros) feeding a GN: the gradient of the
    sum of squares is 2x = 0 there, not vector_norm's 0/0."""
    x = torch.randn(2, 4, 3, 2, 8, generator=torch.Generator().manual_seed(0))
    x[..., 3] = 0.0
    x = x.to(dtype).requires_grad_()
    mu, rstd = port.group_norm_stats(x, 4)
    (mu.sum() + rstd.sum()).backward()
    assert torch.isfinite(x.grad).all()
    assert x.grad.dtype == dtype


def test_dw_kernel_wrapper_refuses_cpu_tensors():
    x, _, _, _, _, _, g = _inputs(6)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):
            k1.conv3x3x3_dw_cuda(T(x).to(dtype), T(g).to(dtype))
