"""The port's selective-scan backward (``selective_scan_bwd_plain``, K4's
plain version, and ``SelectiveScanFn``'s autograd) against JAX: the VJP
of the associative scan and of the Pallas kernel (interpret mode, which
runs ``_backward`` and so K4's JAX body), on the same numpy inputs and
cotangent, in f32.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|) per gradient;
both sides keep f32 state and sum dA/dB/dC/dD in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.ops.pallas.selective_scan import selective_scan_pallas
from gfe_mamba_tpu.ops.scan import selective_scan as jax_selective_scan
from gfe_mamba_torch.ops.cuda import selective_scan as k2
from gfe_mamba_torch.ops.scan import selective_scan

torch.set_num_threads(2)

REL = 1e-4
NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")


def _assert_close(got, want, name, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (name, err)


def _inputs(seed, bsz=2, L=7, ED=6, N=4, gate=True, bias=True,
            softplus=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, L, ED).astype(np.float32)
    delta = (rng.randn(bsz, L, ED) * 0.5).astype(np.float32)
    if not softplus:             # a real step is positive without softplus
        delta = np.abs(delta)
    A = -np.abs(rng.randn(ED, N)).astype(np.float32)
    B = rng.randn(bsz, L, N).astype(np.float32)
    C = rng.randn(bsz, L, N).astype(np.float32)
    D = rng.randn(ED).astype(np.float32)
    z = rng.randn(bsz, L, ED).astype(np.float32) if gate else None
    b = (rng.randn(ED) * 0.1).astype(np.float32) if bias else None
    g = rng.randn(bsz, L, ED).astype(np.float32)
    return [x, delta, A, B, C, D, z, b], g


def _jax_grads(fn, args, g, softplus):
    """VJP of ``fn`` w.r.t. every present input, None where absent."""
    present = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, v in zip(present, xs):
            full[i] = v
        x, delta, A, B, C, D, z, b = full
        return fn(x, delta, A, B, C, D, z=z, delta_bias=b,
                  delta_softplus=softplus)

    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in present))
    grads = [None] * 8
    for i, d in zip(present, vjp(jnp.asarray(g))):
        grads[i] = np.asarray(d)
    return grads


def _associative(*args, **kw):
    return jax_selective_scan(*args, mode="associative", **kw)


def _pallas(*args, **kw):
    return selective_scan_pallas(*args, interpret=True, **kw)


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


VARIANTS = [(True, True, True, 6), (False, False, True, 6),
            (True, False, False, 6), (False, True, False, 10),
            (True, True, True, 10)]


@pytest.mark.parametrize("gate,bias,softplus,ED", VARIANTS)
def test_bwd_plain_matches_associative_vjp(gate, bias, softplus, ED):
    args, g = _inputs(0, ED=ED, gate=gate, bias=bias, softplus=softplus)
    want = _jax_grads(_associative, args, g, softplus)
    got = k2.selective_scan_bwd_plain(*_torch(args), torch.from_numpy(g),
                                      delta_softplus=softplus)
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            _assert_close(a, b, name)


@pytest.mark.parametrize("gate,bias,ED", [(True, True, 6), (False, False, 10)])
def test_scan_autograd_matches_pallas_kernel_interpret(gate, bias, ED):
    """SelectiveScanFn's backward against the Pallas kernel's fused
    backward run in interpret mode."""
    args, g = _inputs(1, ED=ED, gate=gate, bias=bias)
    want = _jax_grads(_pallas, args, g, True)
    targs = [None if a is None else a.requires_grad_()
             for a in _torch(args)]
    selective_scan(*targs, delta_softplus=True).backward(
        torch.from_numpy(g))
    for name, a, b in zip(NAMES, targs, want):
        if b is not None:
            _assert_close(a.grad, b, name)


def test_scan_grads_come_back_in_each_input_dtype():
    args, g = _inputs(2)
    targs = _torch(args)
    x = targs[0].bfloat16().requires_grad_()
    rest = [t.requires_grad_() for t in targs[1:]]
    y = selective_scan(x, *rest, delta_softplus=True)
    assert y.dtype == torch.bfloat16
    y.float().backward(torch.from_numpy(g))
    assert x.grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in rest)
    # the f32 gradient of x, rounded once; the cotangent reaches the scan
    # through y's bf16 -> f32 cast, so it is g rounded to bf16
    want = k2.selective_scan_bwd_plain(
        x.detach().float(), *[t.detach() for t in rest],
        torch.from_numpy(g).bfloat16().float(), delta_softplus=True)[0]
    assert torch.equal(x.grad, want.bfloat16())


def test_scan_bwd_kernel_wrapper_refuses_cpu_tensors():
    args, g = _inputs(3)
    with pytest.raises(ValueError):
        k2.selective_scan_bwd_cuda(*_torch(args), torch.from_numpy(g))
