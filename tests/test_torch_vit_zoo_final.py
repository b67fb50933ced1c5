"""The port's ``models/vit_zoo_final.py`` against the JAX package's, on the
CPU at tiny widths.

Each JAX model is initialized, every variable moved off its init, carried
to the port by ``state_dict_from_jax(variables, model)`` and loaded
strictly; both run the same numpy inputs.  Outputs, losses and gradients
agree within 1e-5 relative to max(1, max |JAX|) in f32.  The draws are
JAX's, handed to the one port method that makes each: ATS's Gumbel
uniforms (those JAX's ``jax.random.uniform`` returns inside the apply),
SimMIM's masked indices and MP3's permutations (from the key each call
takes); ATS's sampled ids must then be JAX's exactly.  The port's own
draws are held to their laws separately.  NaViT's packer is a numpy copy
of JAX's and must give the same buffers bit for bit, token dropout
included.  MaxViT-with-registers' train-mode BatchNorms run in f64 on
both sides at 1e-6, as in ``test_torch_vit_zoo_hier.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo_final as jf
from gfe_mamba_torch.models import vit_zoo_final as pf
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
REL = 1e-5


def _close(got, want, tag="", rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, (tag, err)


def _moved(jmod, *args, seed=0, rngs=None):
    """JAX variables from ``init`` with every leaf moved off its init
    (running variances kept positive)."""
    rngs = {"params": jax.random.key(seed), **(rngs or {})}
    variables = jax.jit(jmod.init)(rngs, *(jnp.asarray(a) for a in args))
    rng = np.random.RandomState(seed + 1)

    def move(path, a):
        a = np.asarray(a)
        noise = 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "var":
            noise = np.abs(noise)
        return jnp.asarray(a + noise)

    return jax.tree_util.tree_map_with_path(move, variables)


def _load(port, variables):
    port.load_state_dict(state_dict_from_jax(variables, port))
    return port


def _img(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _grads_close(port, grads, tag):
    """Every port gradient against JAX's; parameters JAX has no gradient
    for (a head the loss does not reach) must have none."""
    want = grads if all(torch.is_tensor(t) for t in grads.values()) \
        else state_dict_from_jax(grads, port)
    for key, p in port.named_parameters():
        if key in want:
            _close(p.grad, want[key].numpy(), f"{tag} {key}")
        else:
            assert p.grad is None, (tag, key)


def _recording_uniform(monkeypatch):
    """jax.random.uniform recording every array it returns, also under
    ``jit`` (an ordered host callback)."""
    draws = []
    uniform = jax.random.uniform

    def recording(*args, **kwargs):
        out = uniform(*args, **kwargs)
        jax.debug.callback(lambda a: draws.append(np.array(a)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jax.random, "uniform", recording)
    return draws


ATS = dict(image_size=(16, 24), patch_size=4, num_classes=3, dim=32,
           depth=3, max_tokens_per_depth=(12, 6, 6), heads=2, mlp_dim=48,
           dim_head=16)


@pytest.mark.parametrize("batch", [1, 3])
def test_ats_vit_matches_jax(monkeypatch, batch):
    """Logits within 1e-5 and the sampled ids exactly JAX's, with JAX's
    uniforms handed to the two sampling layers (the third keeps its 6
    tokens and draws nothing)."""
    x = _img(40 + batch, batch, 16, 24, 3)
    jmod = jf.ATSViT(**ATS)
    v = _moved(jmod, x, rngs={"gumbel": jax.random.key(5)})
    port = _load(pf.ATSViT(**ATS).eval(), v)
    draws = _recording_uniform(monkeypatch)
    want, want_ids = jax.jit(partial(
        jmod.apply, return_sampled_token_ids=True))(
        v, jnp.asarray(x), rngs={"gumbel": jax.random.key(7)})
    jax.effects_barrier()
    assert [d.shape for d in draws] == [(batch, 12, 24), (batch, 6, 12)]
    for i, d in enumerate(draws):
        getattr(port, f"attn_{i}").uniforms = \
            (lambda d: lambda shape, gen, device: torch.tensor(d))(d)
    with torch.no_grad():
        got, ids = port(torch.from_numpy(x), torch.Generator(),
                        return_sampled_token_ids=True)
    _close(got, want, "ATS logits")
    assert np.array_equal(ids.numpy(), np.asarray(want_ids))
    assert (ids.numpy() == -1).any() or batch == 1


def test_ats_uniforms_law():
    """Uniforms in [0, 1), reproducible from the generator's seed; the
    sampler keeps each kept id once, ascending, padding (0) on the right."""
    a = pf._ATSAttention.uniforms((400, 50), torch.Generator().manual_seed(2),
                                  "cpu")
    b = pf._ATSAttention.uniforms((400, 50), torch.Generator().manual_seed(2),
                                  "cpu")
    assert torch.equal(a, b) and a.min() >= 0 and a.max() < 1
    assert abs(a.mean().item() - 0.5) < 0.01
    gen = torch.Generator().manual_seed(3)
    attn = torch.softmax(torch.randn(4, 2, 9, 9, generator=gen), -1)
    v = torch.randn(4, 2, 9, 5, generator=gen)
    ids, mask = pf._ats_sample(attn, v, torch.ones(4, 9, dtype=torch.bool),
                               6, torch.rand(4, 6, 8, generator=gen))
    for row, m in zip(ids, mask):
        kept = row[1:][m[1:]]
        assert row[0] == 0 and torch.equal(kept, kept.unique())
        assert (row[1:][~m[1:]] == 0).all()
        assert m[1:].tolist() == sorted(m[1:].tolist(), reverse=True)


RVT = {
    "rotary+conv+glu": dict(image_size=16, patch_size=4, num_classes=3,
                            dim=24, depth=2, heads=2, mlp_dim=40,
                            dim_head=16),
    "plain": dict(image_size=16, patch_size=4, num_classes=3, dim=32,
                  depth=2, heads=2, mlp_dim=40, dim_head=16,
                  use_rotary=False, use_ds_conv=False, use_glu=False),
}


@pytest.mark.parametrize("case", sorted(RVT))
def test_rvt_matches_jax(case):
    """The first case has dim != heads * dim_head (CLS projected on its
    own by the conv query)."""
    kw = RVT[case]
    x = _img(50, 2, 16, 16, 3)
    jmod = jf.RvT(**kw)
    v = _moved(jmod, x)
    port = _load(pf.RvT(**kw).eval(), v)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)),
               case)
    _close(pf._axial_rotary(4, 16, 16.0)[0],
           jf._axial_rotary(4, 16, 16.0)[0], "sin")


def _navit_images(seed):
    rng = np.random.default_rng(seed)
    sides = [(8, 8), (16, 8), (8, 16), (16, 16), (4, 12)]
    return [rng.normal(size=(h, w, 3)).astype(np.float32) for h, w in sides]


@pytest.mark.parametrize("dropout", [None, 0.25, "callable"])
def test_navit_packer_equals_jax(dropout):
    """Grouping and packing, bit for bit, with JAX's numpy draws for the
    token dropout."""
    prob = (lambda h, w: 0.5 if h * w > 128 else 0.1) \
        if dropout == "callable" else dropout
    calc = prob if callable(prob) or prob is None else \
        (lambda h, w: prob)
    images = _navit_images(60)
    got_groups = pf.group_images_by_max_seq_len(images, 4, calc, 20)
    want_groups = jf.group_images_by_max_seq_len(images, 4, calc, 20)
    assert [len(g) for g in got_groups] == [len(g) for g in want_groups]
    got = pf.pack_images(got_groups, 4, 20, prob, seed=4)
    want = jf.pack_images(want_groups, 4, 20, prob, seed=4)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def test_navit_packed_forward_matches_jax():
    """Logits and validity over packed groups; the padding slots' logits
    are free, only the valid ones are compared beside the mask."""
    groups = pf.group_images_by_max_seq_len(_navit_images(61), 4, None, 24)
    packed = pf.pack_images(groups, 4, 24, 0.25, seed=1)
    kw = dict(image_size=16, patch_size=4, num_classes=3, dim=32, depth=2,
              heads=2, mlp_dim=48, max_images=3, dim_head=16)
    names = ("patches", "positions", "image_ids", "mask")
    args = [packed[k] for k in names]
    jmod = jf.NaViT(**kw)
    v = _moved(jmod, *args)
    port = _load(pf.NaViT(**kw).eval(), v)
    want, want_valid = jax.jit(jmod.apply)(v, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got, valid = port(*(torch.from_numpy(a) for a in args))
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    assert not valid.all()
    _close(got, want, "NaViT logits")


def test_simmim_loss_and_gradients_match_jax():
    """JAX's masked indices (the top-k of its uniforms from the key)."""
    kw = dict(image_size=(16, 20), patch_size=4, dim=32, depth=2, heads=2,
              mlp_dim=48, masking_ratio=0.5, dim_head=16)
    x = _img(70, 3, 16, 20, 1)
    key = jax.random.key(9)
    jmod = jf.SimMIM(**kw)
    v = _moved(jmod, x, key)
    port = _load(pf.SimMIM(**kw, channels=1), v)
    idx = np.asarray(jax.lax.top_k(jax.random.uniform(key, (3, 20)), 10)[1])
    port.masked_indices = lambda *a: torch.from_numpy(idx).long()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply({"params": p}, jnp.asarray(x), key)))(
        v["params"])
    got = port(torch.from_numpy(x), torch.Generator())
    _close(got, loss, "SimMIM loss")
    got.backward()
    _grads_close(port, grads, "SimMIM")


def test_simmim_masked_indices_law():
    """num_masked distinct patches per sample, every patch equally likely,
    reproducible from the generator's seed."""
    a = pf.SimMIM.masked_indices(2000, 16, 4, torch.Generator().manual_seed(5),
                                 "cpu")
    b = pf.SimMIM.masked_indices(2000, 16, 4, torch.Generator().manual_seed(5),
                                 "cpu")
    assert torch.equal(a, b) and a.shape == (2000, 4)
    assert all(len(set(row.tolist())) == 4 for row in a[:100])
    freq = torch.bincount(a.flatten(), minlength=16).double() / a.numel()
    assert (freq - 1 / 16).abs().max() < 0.01


MP3_KW = dict(image_size=(16, 20), patch_size=4, num_classes=5, dim=32,
              depth=2, heads=2, mlp_dim=48, dim_head=16)


def test_mp3vit_matches_jax():
    x = _img(80, 2, 16, 20, 3)
    jmod = jf.MP3ViT(**MP3_KW)
    v = _moved(jmod, x)
    port = _load(pf.MP3ViT(**MP3_KW).eval(), v)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)),
               "MP3ViT")


def test_mp3_loss_and_gradients_match_jax():
    """JAX's per-sample permutations (vmapped over the split key); flax's
    MP3 tree lacks the ViT's head, taken from the ViT's own variables."""
    x = _img(81, 3, 16, 20, 3)
    key = jax.random.key(13)
    jvit = jf.MP3ViT(**MP3_KW)
    jmod = jf.MP3(vit=jvit, masking_ratio=0.5)
    v = _moved(jmod, x, key)
    head = _moved(jvit, x, seed=2)["params"]
    assert "head" not in v["params"]["vit"]
    merged = jax.tree_util.tree_map(lambda a: a, v)
    merged["params"]["vit"] = {**v["params"]["vit"],
                               "head_norm": head["head_norm"],
                               "head": head["head"]}
    port = _load(pf.MP3(pf.MP3ViT(**MP3_KW), 0.5), merged)
    order = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 20))(
        jax.random.split(key, 3)))
    port.permutation = lambda *a: torch.from_numpy(order).long()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply({"params": p}, jnp.asarray(x), key)))(
        v["params"])
    got = port(torch.from_numpy(x), torch.Generator())
    _close(got, loss, "MP3 loss")
    got.backward()
    want = state_dict_from_jax({**grads, "vit": {
        **grads["vit"], "head_norm": head["head_norm"],
        "head": head["head"]}}, port)
    _grads_close(port, {k: t for k, t in want.items()
                        if not k.startswith("vit.head")}, "MP3")


def test_mp3_permutation_law():
    """Each row a permutation, every position equally likely in front."""
    perm = pf.MP3.permutation(4000, 8, torch.Generator().manual_seed(6),
                              "cpu")
    assert torch.equal(perm.sort(dim=1).values,
                       torch.arange(8).expand(4000, 8))
    freq = torch.bincount(perm[:, 0], minlength=8).double() / 4000
    assert (freq - 1 / 8).abs().max() < 0.02


DISTILL = dict(image_size=(16, 20), patch_size=4, num_classes=4, dim=32,
               depth=2, heads=2, mlp_dim=48, dim_head=16)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_distillable_vit_matches_jax(pool):
    x = _img(90, 2, 16, 20, 3)
    kw = dict(DISTILL, pool=pool)
    jmod = jf.DistillableViT(**kw)
    v = _moved(jmod, x)
    port = _load(pf.DistillableViT(**kw).eval(), v)
    token = np.random.RandomState(3).randn(1, 1, 32).astype(np.float32)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)),
               "plain")
        got = port(torch.from_numpy(x), torch.from_numpy(token))
    want = jax.jit(jmod.apply)(v, jnp.asarray(x), jnp.asarray(token))
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"distilling {i}")


@pytest.mark.parametrize("hard", [False, True])
def test_distill_wrapper_loss_and_gradients_match_jax(hard):
    x = _img(91, 3, 16, 20, 3)
    labels = np.array([1, 3, 0])
    teacher = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    jmod = jf.DistillWrapper(student=jf.DistillableViT(**DISTILL),
                             temperature=2.0, alpha=0.3, hard=hard)
    v = _moved(jmod, x, labels, teacher)
    port = _load(pf.DistillWrapper(pf.DistillableViT(**DISTILL), 2.0, 0.3,
                                   hard), v)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmod.apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(labels),
        jnp.asarray(teacher))))(v["params"])
    got = port(torch.from_numpy(x), torch.from_numpy(labels),
               torch.from_numpy(teacher))
    _close(got, loss, "distill loss")
    got.backward()
    _grads_close(port, grads, "DistillWrapper")


MEM = dict(image_size=(16, 20), patch_size=4, num_classes=3, dim=32,
           depth=2, heads=2, mlp_dim=48, dim_head=16)


def test_memory_vit_and_adapter_match_jax():
    """The backbone and the adapter (flax's adapter tree lacks the
    backbone's head, taken from the backbone's own variables); under the
    one-way mask the backbone's tokens are the same with and without the
    memories."""
    x = _img(100, 2, 16, 20, 3)
    jvit = jf.MemoryViT(**MEM)
    vv = _moved(jvit, x)
    vit = _load(pf.MemoryViT(**MEM).eval(), vv)
    with torch.no_grad():
        _close(vit(torch.from_numpy(x)),
               jax.jit(jvit.apply)(vv, jnp.asarray(x)),
               "MemoryViT")
    jmod = jf.MemoryAdapter(vit=jvit, num_memories_per_layer=4,
                            num_classes=2)
    va = _moved(jmod, x, seed=3)
    assert "head" not in va["params"]["vit"]
    merged = {"params": {**va["params"], "vit": {
        **va["params"]["vit"], "head_norm": vv["params"]["head_norm"],
        "head": vv["params"]["head"]}}}
    port = _load(pf.MemoryAdapter(pf.MemoryViT(**MEM), 4, 2).eval(), merged)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(va, jnp.asarray(x)),
               "MemoryAdapter")
        tokens = port.vit.img_to_tokens(torch.from_numpy(x))
        alone = port.vit.transformer(tokens)
        mem_cls = port.memory_cls_token.expand(2, 1, -1)
        joint = port.vit.transformer(torch.cat([mem_cls, tokens], 1),
                                     port.attn_mask, port.memories_per_layer)
    _close(joint[:, 1:], alone, "backbone tokens", 1e-6)


def test_esvit_projector_and_losses_match_jax():
    rng = np.random.RandomState(110)
    x = rng.randn(3, 5, 12).astype(np.float32)
    jmod = jf.EsViTProjector(dim_out=8, num_layers=3, hidden_size=16)
    v = _moved(jmod, x)
    port = _load(pf.EsViTProjector(8, 3, 16, dim=12), v)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)),
               "projector")
    t, s = (rng.randn(3, 5, 8).astype(np.float32) for _ in range(2))
    tl, sl = (rng.randn(3, 5, 6).astype(np.float32) for _ in range(2))
    c = rng.randn(1, 8).astype(np.float32) * 0.1
    T = torch.from_numpy
    _close(pf.esvit_view_loss(T(t), T(s), T(c)),
           jf.esvit_view_loss(t, s, c), "view")
    _close(pf.esvit_view_loss(T(t), T(s), T(c), 0.07, 0.5),
           jf.esvit_view_loss(t, s, c, 0.07, 0.5), "view temps")
    _close(pf.esvit_region_loss(T(t), T(s), T(tl), T(sl), T(c)),
           jf.esvit_region_loss(t, s, tl, sl, c), "region")
    _close(pf.esvit_center_update(T(c[0]), T(t[0, 0])),
           jf.esvit_center_update(c[0], t[0, 0]), "center")
    # the teacher takes no gradient, the student its own
    tt, ss = T(t).requires_grad_(), T(s).requires_grad_()
    pf.esvit_region_loss(tt, ss, T(tl), T(sl), T(c)).backward()
    assert tt.grad is None and ss.grad is not None
    g = jax.grad(lambda a: jf.esvit_region_loss(t, a, tl, sl, c))(s)
    _close(ss.grad, g, "region grad")


REGISTERS = dict(num_classes=3, dim=16, depth=(1, 2), dim_head=8,
                 window_size=2, num_register_tokens=3)


def test_maxvit_with_registers_matches_jax():
    """Eval in f32 on a non-square map; train mode (batch statistics and
    the running statistics they move) in f64."""
    x = _img(120, 4, 32, 48, 3)
    jmod = jf.MaxViTWithRegisters(**dict(REGISTERS, dropout=0.0))
    v = _moved(jmod, x)
    port = _load(pf.MaxViTWithRegisters(**dict(REGISTERS, dropout=0.0))
                 .eval(), v)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)),
               jax.jit(jmod.apply)(v, jnp.asarray(x)),
               "eval")
    assert np.array_equal(pf._register_bias_indices(3, 2),
                          jf._register_bias_indices(3, 2))
    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).double())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v)
        out, moved = jax.jit(partial(jmod.apply, train=True,
                                     mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64))
        out, moved = jax.tree_util.tree_map(np.asarray, (out, moved))
    assert out.dtype == np.float64
    _close(got, out, "train", 1e-6)
    after = state_dict_from_jax({"params": v["params"], **moved}, port)
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            _close(value, after[key].numpy(), key, 1e-6)
