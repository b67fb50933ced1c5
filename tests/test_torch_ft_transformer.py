"""The port's attention, FT-Transformer models and the Jamba and ablation
classifier heads against the JAX package's: flax init, weights carried
across with ``state_dict_from_jax``, the same numpy inputs from a seed
through both, f32 on the CPU, dropout off.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import attention as ja
from gfe_mamba_tpu.models import ft_transformer as jft
from gfe_mamba_tpu.models import fusion as jfu
from gfe_mamba_torch.models import attention as pa
from gfe_mamba_torch.models import ft_transformer as pft
from gfe_mamba_torch.models import fusion as pfu
from gfe_mamba_torch.utils.convert import (flatten_tree,
                                           jax_tree_from_state_dict,
                                           state_dict_from_jax)

torch.set_num_threads(2)

REL = 1e-4
CATS, NCONT, DIM = (3, 5, 2), 4, 32
RNG = np.random.RandomState(0)
X_CAT = RNG.randint(0, 2, (2, 3)).astype(np.int32)
X_NUM = RNG.randn(2, NCONT).astype(np.float32)
FEATURE = RNG.randn(2, 4, DIM).astype(np.float32)
VOLS = [RNG.randn(2, 6, 5, 4, 1).astype(np.float32) for _ in range(2)]
D_CROSS = 6 * 5
COND = RNG.randn(2, 6, 48).astype(np.float32)
HEAD = dict(dim=DIM, depth=2, heads=2, dim_head=8)


def _assert_close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _to_jax(a):
    return [jnp.asarray(v) for v in a] if isinstance(a, list) \
        else (None if a is None else jnp.asarray(a))


def _to_torch(a):
    if isinstance(a, list):
        return [torch.from_numpy(v) for v in a]
    return None if a is None else torch.from_numpy(a)


def _carry(jax_module, port_module, *inputs, **kw):
    """flax init on ``inputs``, the weights into ``port_module``; the
    conversion must also invert exactly.  Returns the flax params."""
    params = jax.jit(lambda key, *a: jax_module.init(key, *a, **kw))(
        jax.random.key(0), *(_to_jax(a) for a in inputs))
    params = jax.tree_util.tree_map(np.asarray, params)
    port_module.load_state_dict(state_dict_from_jax(params))
    back = flatten_tree(jax_tree_from_state_dict(port_module.state_dict()))
    want = flatten_tree(params["params"])
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)
    port_module.eval()
    return params


def _compare(jax_module, port_module, params, *inputs, **kw):
    want = jax.jit(lambda p, *a: jax_module.apply(p, *a, **kw))(
        params, *(_to_jax(a) for a in inputs))
    with torch.no_grad():
        got = port_module(*(_to_torch(a) for a in inputs), **kw)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _assert_close(g, w)
    else:
        _assert_close(got, want)


@pytest.mark.parametrize("causal_mask", [False, True])
def test_self_attention(causal_mask):
    x = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32)
    jax_module, port = ja.SelfAttention(n_heads=2), pa.SelfAttention(2, 16)
    params = _carry(jax_module, port, x)
    _compare(jax_module, port, params, x, causal_mask=causal_mask)


def test_ft_encoder_returns_attention_maps():
    x = np.random.RandomState(2).randn(2, 5, 16).astype(np.float32)
    jax_module = jft.FTTransformerEncoder(depth=2, heads=2, dim_head=8)
    port = pft.FTTransformerEncoder(16, 2, 2, 8)
    params = _carry(jax_module, port, x)
    _compare(jax_module, port, params, x, return_attn=True)


def _models():
    """(name, JAX module, port module, inputs, apply kwargs)."""
    both = (X_CAT, X_NUM, FEATURE, VOLS)
    yield ("CrossTransformerBoth", jft.CrossTransformerBoth(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.CrossTransformerBoth(CATS, NCONT, d_cross=D_CROSS, **HEAD),
        both, {})
    yield ("CrossTransformerBoth-no-condition", jft.CrossTransformerBoth(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.CrossTransformerBoth(CATS, NCONT, d_cross=None, **HEAD),
        (X_CAT, X_NUM, FEATURE), {})
    yield ("CrossTransformer", jft.CrossTransformer(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.CrossTransformer(CATS, NCONT, d_cross=D_CROSS, **HEAD),
        (X_CAT, X_NUM, FEATURE, VOLS[0]), {})
    yield ("FTTransformerCrossImg", jft.FTTransformerCrossImg(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.FTTransformerCrossImg(CATS, NCONT, d_cross=D_CROSS, **HEAD),
        (X_CAT, X_NUM, FEATURE, VOLS[1]), {})
    yield ("FTTransformer", jft.FTTransformer(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.FTTransformer(CATS, NCONT, **HEAD), (X_CAT, X_NUM), {})
    yield ("FTTransformerCross", jft.FTTransformerCross(
        categories=CATS, num_continuous=NCONT, **HEAD),
        pft.FTTransformerCross(CATS, NCONT, d_cross=48, **HEAD),
        (X_CAT, X_NUM, COND), {"return_attn": True})
    # depth 3: six layers, layer 4 attention (8 query = 8 key/value heads)
    yield ("CrossJambaBoth", jfu.CrossJambaBoth(
        categories=CATS, num_continuous=NCONT, dim=DIM, depth=3, heads=8,
        num_experts=2, num_experts_per_tok=2),
        pfu.CrossJambaBoth(CATS, NCONT, dim=DIM, depth=3, heads=8,
                           d_cross=D_CROSS, num_experts=2),
        both, {})


MODELS = {name: rest for name, *rest in _models()}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jax_module, port, inputs, kw = MODELS[name]
    params = _carry(jax_module, port, *inputs)
    _compare(jax_module, port, params, *inputs, **kw)


def test_cross_jamba_both_routes_through_attention_and_experts():
    port = MODELS["CrossJambaBoth"][1]
    layers = port.transformer.layers
    assert [layer.is_attn for layer in layers] == [False] * 4 + [True, False]
    assert [layer.moe.num_experts for layer in layers] == [1, 2] * 3


@pytest.mark.parametrize("path", ["full", "no_feature", "no_condition",
                                  "no_table"])
def test_cross_mamba_ablation_paths(path):
    jax_module = jfu.CrossMambaAblation(categories=CATS,
                                        num_continuous=NCONT, dim=DIM,
                                        depth=2, heads=2)
    port = pfu.CrossMambaAblation(CATS, NCONT, dim=DIM, depth=2, heads=2,
                                  d_cross=D_CROSS)
    params = _carry(jax_module, port, X_CAT, X_NUM, FEATURE, VOLS)
    inputs = {"full": (X_CAT, X_NUM, FEATURE, VOLS),
              "no_feature": (X_CAT, X_NUM, None, VOLS),
              "no_condition": (X_CAT, X_NUM, FEATURE, None),
              "no_table": (X_CAT, X_NUM, FEATURE, VOLS)}[path]
    kw = {"no_table": True} if path == "no_table" else {}
    _compare(jax_module, port, params, *inputs, **kw)


def _mamba_head():
    return pfu.CrossMambaBoth(CATS, NCONT, dim=DIM, depth=1, heads=2,
                              d_cross=D_CROSS)


def test_embed_offsets_survive_to_empty_and_stay_out_of_the_state_dict():
    """A head built on the meta device and materialised with ``to_empty``
    (as the builders do) embeds as one built in place, exactly, and both
    index the embedding at the columns' JAX offsets; the state_dict holds
    the reference's keys before and after a call."""
    torch.manual_seed(0)
    normal = _mamba_head()
    with torch.device("meta"):
        empty = _mamba_head()
    empty.to_empty(device="cpu")
    empty.load_state_dict(normal.state_dict())
    keys = list(normal.state_dict())
    assert keys[:4] == ["cls_token", "categorical_embeds.weight",
                        "numerical_embedder.weights",
                        "numerical_embedder.biases"]
    assert list(empty.state_dict()) == keys
    x_cat, x_num = torch.from_numpy(X_CAT), torch.from_numpy(X_NUM)
    with torch.no_grad():
        got, want = empty.embed(x_cat, x_num), normal.embed(x_cat, x_num)
        cats = normal.categorical_embeds(x_cat.long() + torch.tensor(
            pft.category_offsets(CATS, pft.NUM_SPECIAL_TOKENS)))
    assert torch.equal(got, want)
    assert torch.equal(want[:, 1:1 + len(CATS)], cats)
    assert list(normal.state_dict()) == keys
    assert list(empty.state_dict()) == keys


def test_embed_trains_after_a_first_call_in_inference_mode():
    """A first call under inference mode (a server's warm-up) leaves the
    module trainable: a later forward and backward through ``embed``
    gives the embedding the gradient of a module never called before."""
    torch.manual_seed(0)
    warmed = _mamba_head()
    fresh = copy.deepcopy(warmed)
    x_cat, x_num = torch.from_numpy(X_CAT), torch.from_numpy(X_NUM)
    with torch.inference_mode():
        warmed.embed(x_cat, x_num)
    for head in (warmed, fresh):
        head.embed(x_cat, x_num).square().sum().backward()
    grad = fresh.categorical_embeds.weight.grad
    assert grad is not None and grad.abs().sum() > 0
    assert torch.equal(warmed.categorical_embeds.weight.grad, grad)
