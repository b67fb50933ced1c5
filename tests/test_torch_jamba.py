"""The port's recurrent step and Jamba against the JAX package's: flax
init, weights carried across with ``state_dict_from_jax``, the same numpy
input from a seed through both, f32 on the CPU (the JAX scan in its
associative mode, the port's in its plain loop).

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|); a recurrence
stepped over L tokens against the forward over the L tokens, within
the same package, at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import jamba as jj
from gfe_mamba_tpu.models import mamba as jm
from gfe_mamba_tpu.ops.scan import selective_scan_step as jax_step
from gfe_mamba_torch.models import jamba as pj
from gfe_mamba_torch.models import mamba as pm
from gfe_mamba_torch.ops.scan import selective_scan_step
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

REL = 1e-4
CFG = dict(d_model=16, n_layers=5, mlp_size=16, num_attention_heads=4,
           num_key_value_heads=2, num_experts=2, num_experts_per_tok=2)
LM_CFG = dict(d_model=16, n_layers=2, mlp_size=32, vocab_size=40,
              num_attention_heads=4, num_key_value_heads=2, num_experts=2,
              num_experts_per_tok=1, attn_layer_offset=0,
              attn_layer_period=2)


def _assert_close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _carry(jax_module, port_module, *inputs):
    """flax init on ``inputs``; the same weights loaded into the port
    module; returns the flax params."""
    params = jax.jit(jax_module.init)(jax.random.key(0),
                                      *(jnp.asarray(v) for v in inputs))
    params = jax.tree_util.tree_map(np.asarray, params)
    port_module.load_state_dict(state_dict_from_jax(params))
    port_module.eval()
    return params


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_selective_scan_step():
    rng = np.random.RandomState(0)
    b, ed, n = 2, 6, 4
    h = rng.randn(b, ed, n).astype(np.float32)
    x = rng.randn(b, ed).astype(np.float32)
    delta = np.abs(rng.randn(b, ed)).astype(np.float32)
    A = -np.abs(rng.randn(ed, n)).astype(np.float32)
    B, C = (rng.randn(b, n).astype(np.float32) for _ in range(2))
    D = rng.randn(ed).astype(np.float32)
    y_want, h_want = jax_step(*(jnp.asarray(v)
                                for v in (h, x, delta, A, B, C, D)))
    y, h_new = selective_scan_step(*_t(h, x, delta, A, B, C, D))
    _assert_close(y, y_want)
    _assert_close(h_new, h_want)


@pytest.mark.parametrize("inner_layernorms", [False, True])
def test_mamba_block_step_matches_jax_and_forward(inner_layernorms):
    """Each step against JAX's step, caches leaf for leaf; L steps
    against the port's forward over the L tokens."""
    cfg = dict(d_model=16, n_layers=2, inner_layernorms=inner_layernorms)
    x = np.random.RandomState(1).randn(2, 7, 16).astype(np.float32)
    jax_model, model = jm.Mamba(jm.MambaConfig(**cfg)), \
        pm.Mamba(pm.MambaConfig(**cfg))
    params = _carry(jax_model, model, x)
    if inner_layernorms:
        assert "dt_layernorm" in params["params"]["layer_0"]["mixer"]
    step = jax.jit(lambda p, v, c: jax_model.apply(p, v, c,
                                                   method=jm.Mamba.step))
    jcaches = jax_model.init_cache(batch=2)
    caches = model.init_cache(2)
    outs = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            want, jcaches = step(params, jnp.asarray(x[:, t]), jcaches)
            got, caches = model.step(torch.from_numpy(x[:, t]), caches)
            _assert_close(got, want)
            for (h, w), (jh, jw) in zip(caches, jcaches):
                _assert_close(h, jh)
                _assert_close(w, jw)
            outs.append(got)
        full = model(torch.from_numpy(x))
    _assert_close(torch.stack(outs, 1), full.numpy())


def test_gqa_attention_with_and_without_cache():
    cfg = jj.JambaConfig(**CFG)
    x = np.random.RandomState(2).randn(2, 4, 16).astype(np.float32)
    jax_model, model = jj.GQAttention(cfg), pj.GQAttention(
        pj.JambaConfig(**CFG))
    params = _carry(jax_model, model, x)
    want, _ = jax_model.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(x))
    assert cache is None
    _assert_close(got, want)
    jcache, cache, outs = (None, None), pj.KVCache(x.shape[1]), []
    with torch.no_grad():
        for t in range(x.shape[1]):
            want, jcache = jax_model.apply(params, jnp.asarray(x[:, t:t + 1]),
                                           jcache)
            got, cache = model(torch.from_numpy(x[:, t:t + 1]), cache)
            _assert_close(got, want)
            _assert_close(cache.k[:, :, :cache.length], jcache[0])
            _assert_close(cache.v[:, :, :cache.length], jcache[1])
            outs.append(got)
    _assert_close(torch.cat(outs, 1), model(torch.from_numpy(x))[0].detach()
                  .numpy())


@pytest.mark.parametrize("num_experts,k", [(4, 2), (1, 1)])
def test_sparse_moe_block(num_experts, k):
    x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32)
    jax_model = jj.SparseMoEBlock(num_experts, k, 8)
    model = pj.SparseMoEBlock(6, num_experts, k, 8)
    params = _carry(jax_model, model, x)
    out_want, logits_want = jax_model.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out, logits = model(torch.from_numpy(x))
    _assert_close(out, out_want)
    _assert_close(logits, logits_want)


def test_jamba_forward_and_step():
    x = np.random.RandomState(4).randn(2, 5, 16).astype(np.float32)
    jax_model, model = jj.Jamba(jj.JambaConfig(**CFG)), \
        pj.Jamba(pj.JambaConfig(**CFG))
    params = _carry(jax_model, model, x)
    want, jlogits = jax.jit(jax_model.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got, logits = model(torch.from_numpy(x))
    _assert_close(got, want)
    assert len(logits) == len(jlogits) == CFG["n_layers"]
    for a, b in zip(logits, jlogits):
        _assert_close(a, b)
    assert [type(layer.self_attn if layer.is_attn else layer.mamba).__name__
            for layer in model.layers] == ["MambaBlock"] * 4 + ["GQAttention"]
    jcaches, outs = jax_model.init_cache(2), []
    caches = model.init_cache(2, max_len=x.shape[1])
    with torch.no_grad():
        for t in range(x.shape[1]):
            step_want, jcaches = jax_model.apply(
                params, jnp.asarray(x[:, t:t + 1]), jcaches,
                method=jj.Jamba.step)
            step_got, caches = model.step(torch.from_numpy(x[:, t:t + 1]),
                                          caches)
            _assert_close(step_got, step_want)
            outs.append(step_got)
    _assert_close(torch.cat(outs, 1), got.numpy())


def test_jamba_lm_forward_step_loss_and_greedy_generate():
    tokens = np.random.RandomState(5).randint(0, 40, (2, 4)).astype(np.int32)
    cfg = jj.JambaConfig(**LM_CFG)
    jax_model, model = jj.JambaLM(cfg), pj.JambaLM(pj.JambaConfig(**LM_CFG))
    params = _carry(jax_model, model, tokens)
    want, jlogits = jax.jit(jax_model.apply)(params, jnp.asarray(tokens))
    t = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        got, router_logits = model(t)
    _assert_close(got, want)
    _assert_close(pj.load_balancing_loss(router_logits, 2, 1),
                  jj.load_balancing_loss(jlogits, 2, 1))

    jcaches = jj.Jamba(cfg).init_cache(batch=2)
    caches, outs = model.jamba.init_cache(2, max_len=tokens.shape[1]), []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            step_want, jcaches = jax_model.apply(
                params, jnp.asarray(tokens[:, i]), jcaches,
                method=jj.JambaLM.step)
            step_got, caches = model.step(t[:, i], caches)
            _assert_close(step_got, step_want)
            outs.append(step_got)
    _assert_close(torch.stack(outs, 1), got.numpy())

    want_tokens = jj.generate(jax_model, params, jnp.asarray(tokens[:, :2]),
                              3, jax.random.key(1), top_k=1)
    got_tokens = pj.generate(model, t[:, :2], 3,
                             torch.Generator().manual_seed(1), top_k=1)
    np.testing.assert_array_equal(got_tokens.numpy(),
                                  np.asarray(want_tokens))


def test_load_balancing_loss_uniform_router():
    """A uniform router: each token picks k experts, each with prob 1/E,
    so the loss is k."""
    loss = pj.load_balancing_loss([torch.zeros(40, 4), torch.ones(40, 1)],
                                  num_experts=4, num_experts_per_tok=2)
    assert abs(float(loss) - 2.0) < 1e-6


def test_gqa_refuses_heads_that_do_not_group():
    with pytest.raises(ValueError, match="heads"):
        pj.GQAttention(pj.JambaConfig(d_model=16, n_layers=1, mlp_size=8,
                                      num_attention_heads=2,
                                      num_key_value_heads=8))
