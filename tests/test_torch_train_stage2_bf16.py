"""The port's bf16 Stage-2 classifier against the JAX package's, on the
CPU at the small widths of ``test_torch_train_stage2.py``: numpy inputs
from a seed, weights carried by ``state_dict_from_jax``, dropout off,
``x_num`` f32 on both sides as the trainers receive it.

flax's layers have ``dtype=None``: each computes in the promoted dtype
of its input and its parameters.  Under the JAX trainer's bf16 cast the
f32 ``x_num`` makes the numerical tokens f32, the concatenations make
the whole token sequence f32, and every layer after them runs in f32 on
bf16-rounded weights; only the categorical tokens, the CLS token and
the cross-attention's keys and values (which read the bf16 volumes)
stay bf16.  The port follows that rule (``models/promote.py``).

(a) The output dtype of every classifier module, forward hooks on the
port against ``capture_intermediates`` in JAX, under the bf16 cast, for
the Mamba, Jamba and transformer heads, the ablation head's three paths
and the tableless Mamba head.

(b) One bf16 Stage-2 step (``ClassifyTrainer``) against JAX's bf16
step: the loss, the logits, every trainable gradient (before the clip)
and the updated parameters.  The frozen generator's bf16 outputs are
JAX's, handed to the port's step by a forward hook: XLA and torch round
the generator's bf16 convolutions, GroupNorms and ViT differently (at
these widths 15 to 73 % of its outputs agree bitwise), and that alone
moves the gradients as far as bf16 against f32 does, outside the heads
this test holds.  Each quantity's tolerance is half its distance between
JAX's bf16 step and JAX's f32 step (the norm of the difference, per
tensor).  Measured at these widths: the loss 8e-5 and the logits 2e-5
of that distance, every gradient of the Mamba layer, the feed-forward,
the logit head, the embedders and the query/output projections at most
7e-3 of it; heads that cast ``x_num`` and the feature tokens to bf16
(and so compute in bf16) read 0.41 to 2.1 (30 of those 31 tensors
above half; loss 0.14, logits 0.28).  Three gradients are held to the
whole distance instead: the biases of the layers that run in bf16 in
both packages (the combiner's projection, the cross-attention's key and
value projections; 0.28, 0.95 and 0.61).  Their gradient is a sum over
rows of a bf16 cotangent, which XLA accumulates in bf16 and torch in
f32, so there the port lies as near JAX's f32 step as JAX's bf16 step
does (checked); the key bias's gradient is zero in exact arithmetic
(the softmax cancels it) and holds rounding noise only.  The updated
parameters: each tensor's largest distance within half JAX's
bf16-against-f32 one plus 1e-6 * max(1, |p|) (torch's and optax's Adam
round their f32 arithmetic differently: up to 7e-6 lr here, as in the
f32 test), the key bias within 2 lr (Adam moves an entry by about
lr * sign(g), and its gradient is noise).

(c) A bf16 model served bf16 ``x_num`` (as ``bench.py`` and the
serving path feed it) computes every classifier module in bf16 in both
packages, and its logits lie within two bf16 ulps (at their magnitude)
of JAX's bf16 forward: one measured, where JAX's own f32 forward lies
two away (the generators' bf16 rounding differs, as in (b)).

The other sites of the same promotion: a bf16 ``Mamba.step`` from f32
caches (f32 out, as JAX's) and the tensor-parallel projections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from gfe_mamba_tpu.models import fusion as jax_fusion
from gfe_mamba_tpu.models.combiners import CombineClassifierVitMid as JaxComb
from gfe_mamba_tpu.models.ft_transformer import \
    CrossTransformerBoth as JaxCrossTransformerBoth
from gfe_mamba_tpu.models.pipeline import GFEMamba as JaxGFEMamba
from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT as JaxGen
from gfe_mamba_tpu.training.classify_trainer import \
    ClassifyTrainer as JaxClassifyTrainer
from gfe_mamba_tpu.training.optim import cast_for_compute as jax_cast
from gfe_mamba_torch.models import fusion
from gfe_mamba_torch.models.ft_transformer import CrossTransformerBoth
from gfe_mamba_torch.models.pipeline import build_gfe_mamba
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.training.optim import cast_for_compute
from gfe_mamba_torch.utils.convert import _port_key, state_dict_from_jax

torch.set_num_threads(2)

IMG = (16, 16, 8)
LR = 1e-4
GEN = dict(f_maps=(8, 16, 32), layer_order="gcr", fold_factor=2,
           vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
           vit_mlp_dim=32)
CLS = dict(categories=(3, 5, 2), num_continuous=4, dim=64, depth=1, heads=2)
BF16 = jnp.bfloat16


def _leaves(out) -> list:
    """The tensors of a module's output, in order (``None`` dropped)."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [] if out is None else [out]


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# (a) ------------------------------------------------------------------

# flax module names the port's rename rules do not cover
_EXTRA = [
    (r"(^|/)ff_(\d+)$", r"\1layers/\2/1"),
    (r"(^|/)ff_(\d+)/(GEGLU|Dropout)_0$",
     lambda m: f"{m.group(1)}layers/{m.group(2)}/1/net/"
               f"{2 if m.group(3) == 'GEGLU' else 3}"),
    (r"(^|/)final_feed/GEGLU_0$", r"\1final_feed/2"),
    (r"(^|/)final_feed/Dropout_0$", r"\1final_feed/3"),
    (r"(^|/)attn_(\d+)/Dropout_0$", r"\1attn_\2/attn_drop"),
    (r"(^|/)self_attn/Dropout_0$", r"\1self_attn/attn_drop"),
]


def _port_module(flax_path: str) -> str:
    """The port's module name of a flax module path ('' the head)."""
    import re
    if flax_path in ("", "embed"):
        return flax_path
    for pattern, repl in _EXTRA:
        flax_path = re.sub(pattern, repl, flax_path)
    return _port_key(flax_path + "/kernel")[:-len(".weight")]


HEADS = {
    "mamba": ("CrossMambaBoth", dict(CLS), {}),
    "jamba": ("CrossJambaBoth", dict(CLS, depth=3, heads=8), {}),
    "transformer": ("CrossTransformerBoth", dict(CLS), {}),
    "ablation": ("CrossMambaAblation", dict(CLS), {}),
    "ablation_no_table": ("CrossMambaAblation", dict(CLS),
                          {"no_table": True}),
    "ablation_no_feature": ("CrossMambaAblation", dict(CLS),
                            {"feature_img": None}),
    "tableless": ("CrossMambaBoth",
                  dict(CLS, categories=(), num_continuous=0), {}),
}


def _heads(name: str, kw: dict):
    """The JAX head and the port's, dropout off."""
    d = dict(kw, cross_ff_dropout=0.0)
    d_cross = IMG[0] * IMG[1]
    if name == "CrossTransformerBoth":
        return (JaxCrossTransformerBoth(dim_head=32, **d),
                CrossTransformerBoth(d_cross=d_cross, dim_head=32, **d))
    jax_cls = getattr(jax_fusion, name)
    return (jax_cls(dim_head=32, **d),
            getattr(fusion, name)(d_cross=d_cross, **d))


def _head_inputs(n_cat: int, n_num: int, dim: int, seed: int = 3):
    """What the generator and the combiner hand the head in the bf16
    step (the feature tokens and the volumes bf16), and the table (x_num
    f32), as numpy."""
    rng = np.random.RandomState(seed)
    return dict(
        x_categ=rng.randint(0, 2, (2, n_cat)).astype(np.int32),
        x_numer=rng.randn(2, n_num).astype(np.float32),
        feature_img=rng.randn(2, 2, dim).astype(np.float32),
        volumes=[rng.randn(2, *IMG, 1).astype(np.float32)
                 for _ in range(2)])


@pytest.mark.parametrize("case", list(HEADS))
def test_classifier_dtypes_match_jax_under_the_bf16_cast(case):
    name, kw, call = HEADS[case]
    jax_head, head = _heads(name, kw)
    inp = _head_inputs(len(kw["categories"]), kw["num_continuous"],
                       kw["dim"])
    feature = call.get("feature_img", inp["feature_img"])
    extra = {k: v for k, v in call.items() if k != "feature_img"}

    def jax_args(cast):
        f = None if feature is None else cast(jnp.asarray(feature))
        return (jnp.asarray(inp["x_categ"]), jnp.asarray(inp["x_numer"]),
                f, [cast(jnp.asarray(v)) for v in inp["volumes"]])

    variables = jax.jit(lambda k: jax_head.init(
        k, *jax_args(lambda a: a), **extra))(jax.random.key(0))
    _, state = jax.jit(lambda v: jax_head.apply(
        v, *jax_args(lambda a: a.astype(BF16)), **extra,
        capture_intermediates=True, mutable=["intermediates"]))(
        jax_cast(variables, BF16))
    want = {}
    for path, value in jax.tree_util.tree_flatten_with_path(
            state["intermediates"],
            is_leaf=lambda x: x is None)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        cut = keys.index("__call__")
        if value is not None:
            want.setdefault("/".join(keys[:cut]), []).append(
                str(value.dtype))

    head.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    head.eval()
    got = {}
    for mname, module in head.named_modules():
        module.register_forward_hook(
            lambda m, i, o, mname=mname: got.__setitem__(
                mname, [_dtype_name(t) for t in _leaves(o)]))
    def embed(*a, _embed=head.embed):
        out = _embed(*a)
        got["embed"] = [_dtype_name(out)]
        return out

    head.embed = embed
    t = [torch.from_numpy(v) for v in inp["volumes"]]
    args = (torch.from_numpy(inp["x_categ"]),
            torch.from_numpy(inp["x_numer"]),
            None if feature is None
            else torch.from_numpy(feature).bfloat16(),
            [v.bfloat16() for v in t])
    with torch.no_grad():
        functional_call(head, cast_for_compute(
            dict(head.named_parameters()), torch.bfloat16), args, extra)

    mapped = {_port_module(p): (p, dts) for p, dts in want.items()}
    # outside training Jamba's attention takes its softmax and dropout
    # fused in scaled_dot_product_attention: no module sees the weights
    mapped = {m: v for m, v in mapped.items()
              if not m.endswith(".self_attn.attn_drop")}
    missing = sorted(p for m, (p, _) in mapped.items() if m not in got)
    assert not missing, missing
    wrong = {m: (p, dts, got[m]) for m, (p, dts) in mapped.items()
             if got[m] != dts}
    assert not wrong, wrong
    # every port module that ran has its flax twin, but for the encoder's
    # two Sequential containers (``to_out``, the feed-forward's ``net``)
    unmatched = sorted(set(got) - set(mapped))
    assert all(m.endswith((".0.to_out", ".1.net")) for m in unmatched), \
        unmatched
    # the promotion reaches the mixer: f32 tokens, bf16 volume keys
    if kw["num_continuous"]:
        assert got["transformer"][0] == "float32"
        assert got[""] == ["float32"]
    if "final_cross" in mapped:
        assert got["final_cross.k_proj"] == ["bfloat16"]


# (b) ------------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, *IMG, 1).astype(np.float32),
            rng.randint(0, 2, (2, 3)).astype(np.int32),
            rng.randn(2, 4).astype(np.float32),
            np.asarray([1.0, 0.0], np.float32))


def _np_state(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, tree)}).items()}


@pytest.fixture(scope="module")
def reference():
    """JAX's f32 and bf16 steps from one init: loss, logits, the
    gradients and the updated parameters of the trainable tensors; the
    bf16 generator's outputs; the bf16 serve forward."""
    pipeline = JaxGFEMamba(
        generator=JaxGen(1, 1, is_segmentation=False, **GEN),
        combiner=JaxComb(seq_length=2),
        classifier=jax_fusion.CrossMambaBoth(dim_head=32,
                                             cross_ff_dropout=0.0, **CLS))
    batch = _batch()
    jb = [jnp.asarray(v) for v in batch]
    params = jax.jit(pipeline.init)(jax.random.key(0), *jb[:3])
    out = dict(batch=batch, params0=jax.tree_util.tree_map(np.array, params))
    for mp in ("none", "bf16"):
        trainer = JaxClassifyTrainer(pipeline, lr=LR, mixed_precision=mp)

        def loss_fn(p, trainer=trainer):
            p = {**p, "generator": jax.lax.stop_gradient(p["generator"])}
            return trainer._loss({**params, "params": p}, *jb,
                                 jax.random.key(1))

        @jax.jit
        def step(p, trainer=trainer):
            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            updates, _ = trainer.tx.update(grads, trainer.tx.init(p), p)
            return loss, logits, grads, jax.tree_util.tree_map(
                lambda a, u: a + u, p, updates)

        loss, logits, grads, new = step(params["params"])
        grads = {k: v for k, v in grads.items() if k != "generator"}
        out[mp] = dict(loss=float(loss), logits=np.asarray(logits),
                       grads=_np_state(grads), params=_np_state(new))
    cast = jax_cast(params, BF16)
    generated = jax.jit(lambda v, m: pipeline.generator.apply(
        {"params": v["params"]["generator"]}, m, output_vit_mid=True))(
        cast, jb[0].astype(BF16))
    out["generator_bf16"] = [np.array(t.astype(jnp.float32))
                             for t in generated]
    logits, state = jax.jit(lambda v, m, n: pipeline.apply(
        v, m, jb[1], n, capture_intermediates=True,
        mutable=["intermediates"]))(cast, jb[0].astype(BF16),
                                    jb[2].astype(BF16))
    out["serve_bf16"] = np.asarray(logits)
    out["serve_classifier_dtypes"] = {
        str(t.dtype) for t in jax.tree_util.tree_leaves(
            state["intermediates"]["classifier"])}
    return out


def _port_model(params0):
    model = build_gfe_mamba(img_size=IMG, device="cpu", seq_length=2,
                            cross_ff_dropout=0.0, **GEN, **CLS)
    model.load_state_dict(state_dict_from_jax(params0))
    return model


# biases of layers that compute in bf16 in both packages (see the module
# docstring): held to JAX's whole bf16-against-f32 distance
BF16_BIASES = ("combiner.vit_mid_linear.bias",
               "classifier.final_cross.k_proj.bias",
               "classifier.final_cross.v_proj.bias")


def _dist(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)))


def test_bf16_step_matches_jax_bf16_step(reference):
    model = _port_model(reference["params0"])
    trainer = ClassifyTrainer(model, lr=LR, mixed_precision="bf16",
                              device="cpu")
    generated = tuple(torch.from_numpy(g).bfloat16()
                      for g in reference["generator_bf16"])
    model.generator.register_forward_hook(lambda m, i, o: generated)
    dtypes = {}
    for name in ("combiner", "classifier.transformer", "classifier"):
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: dtypes.__setitem__(name, o.dtype))
    batch = [torch.from_numpy(v) for v in reference["batch"]]
    model.train()
    with torch.no_grad():
        logits = trainer._logits(*batch[:3]).numpy()
    assert dtypes == {"combiner": torch.bfloat16,
                      "classifier.transformer": torch.float32,
                      "classifier": torch.float32}
    grads, logs = trainer.gradients(*batch)
    assert trainer.train_step(*batch)["skipped"] == 0.0

    jb, jf = reference["bf16"], reference["none"]
    assert abs(logs["cla_loss"] - jb["loss"]) \
        <= 0.5 * abs(jb["loss"] - jf["loss"])
    assert _dist(logits, jb["logits"]) \
        <= 0.5 * _dist(jb["logits"], jf["logits"])

    assert set(trainer.trainable) == set(jb["grads"])
    for name, g in zip(trainer.trainable, grads):
        g = g.numpy()
        ref = _dist(jb["grads"][name], jf["grads"][name])
        if name in BF16_BIASES:
            assert _dist(g, jb["grads"][name]) <= ref, name
            assert _dist(g, jf["grads"][name]) <= ref, name
        else:
            assert _dist(g, jb["grads"][name]) <= 0.5 * ref, name

    for name, p in trainer.trainable.items():
        got = p.detach().numpy()
        want, other = jb["params"][name], jf["params"][name]
        if name == "classifier.final_cross.k_proj.bias":
            tol = 2.0001 * LR
        else:
            tol = 0.5 * np.abs(want - other).max() \
                + 1e-6 * max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= tol, name


# (c) ------------------------------------------------------------------

def test_bf16_serve_forward_stays_bf16_and_matches_jax(reference):
    model = _port_model(reference["params0"]).to(torch.bfloat16).eval()
    dtypes = {}
    for name, module in model.classifier.named_modules():
        module.register_forward_hook(
            lambda m, i, o, name=name: dtypes.__setitem__(
                name, {t.dtype for t in _leaves(o)}))
    mri, x_cat, x_num, _ = (torch.from_numpy(v) for v in reference["batch"])
    with torch.no_grad():
        logits = model(mri.bfloat16(), x_cat, x_num.bfloat16())
    assert logits.dtype == torch.bfloat16
    assert dtypes and all(d == {torch.bfloat16} for d in dtypes.values()), \
        dtypes
    want = reference["serve_bf16"]
    assert want.dtype == BF16
    assert reference["serve_classifier_dtypes"] == {"bfloat16"}
    want = want.astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(logits.float().numpy() - want).max() <= 2 * ulp


# the other sites of the same promotion --------------------------------

def test_bf16_recurrent_step_promotes_as_jax_step():
    """``Mamba.step`` of a bf16 model from f32 caches (``init_cache``'s
    default), bf16 tokens: JAX's step promotes the window, the state and
    so the output and every later layer to f32; the port's does too, and
    agrees within 2 ** -6 of the output's magnitude over 3 steps (the
    layers' inputs are bf16-rounded alike; the rest runs in f32)."""
    from gfe_mamba_tpu.models import mamba as jm
    from gfe_mamba_torch.models import mamba as pm

    cfg = dict(d_model=16, n_layers=2)
    x = np.random.RandomState(4).randn(2, 3, 16).astype(np.float32)
    jax_model = jm.Mamba(jm.MambaConfig(**cfg))
    model = pm.Mamba(pm.MambaConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init)(
        jax.random.key(0), jnp.asarray(x)))
    model.load_state_dict(state_dict_from_jax(params))
    model = model.to(torch.bfloat16).eval()
    step = jax.jit(lambda p, v, c: jax_model.apply(p, v, c,
                                                   method=jm.Mamba.step))
    jparams = jax_cast(params, BF16)
    jcaches, caches = jax_model.init_cache(batch=2), model.init_cache(2)
    with torch.no_grad():
        for t in range(x.shape[1]):
            token = jnp.asarray(x[:, t]).astype(BF16)
            want, jcaches = step(jparams, token, jcaches)
            got, caches = model.step(
                torch.from_numpy(x[:, t]).bfloat16(), caches)
            assert str(want.dtype) == "float32" == _dtype_name(got)
            assert [_dtype_name(c) for c in _leaves(caches)] == \
                [str(c.dtype) for c in _leaves(jcaches)]
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() \
                <= 2.0 ** -6 * max(1.0, np.abs(want).max())


def test_parallel_linears_promote_as_the_layers_they_replace():
    """The tensor-parallel projections compute in the promoted dtype of
    their input and their shard, as the ``Linear`` they replace: f32
    input on bf16 weights gives f32 (the bf16 Stage-2 step's query side),
    bf16 on bf16 stays bf16 (its key/value side).  A group of one: each
    holds the whole weight."""
    from gfe_mamba_torch.models.promote import Linear
    from gfe_mamba_torch.parallel.sharding import (ColumnParallelLinear,
                                                   RowParallelLinear)

    torch.manual_seed(0)
    linear = Linear(8, 4).to(torch.bfloat16)
    x = torch.randn(3, 8)
    for cls in (ColumnParallelLinear, RowParallelLinear):
        tp = cls(linear, None)
        for inp in (x, x.bfloat16()):
            got, want = tp(inp), linear(inp)
            assert got.dtype == want.dtype == inp.dtype, cls
            # the bias is added after the product there (one more
            # rounding in bf16): torch's default tolerance of the dtype
            torch.testing.assert_close(got, want)
    assert linear(x).dtype == torch.float32
    torch.testing.assert_close(
        linear(x), x @ linear.weight.float().T + linear.bias.float())
