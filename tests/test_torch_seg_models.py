"""The port's segmentation blocks and UNet families against the JAX
package's, on the CPU at tiny widths, f32.

Each block or model is built in the port, its weights drawn under flax's
law and its norms' affines and running statistics perturbed, carried to
JAX with ``utils/convert.py`` (``jax_variables_from_state_dict``), and
both sides run the same numpy input.  Tolerance: 1e-4 relative to
max(1, max |JAX|), for outputs and for the BatchNorm statistics a
train-mode forward moves (f32 convs in two summation orders).  The conv
rule is held on both sides of its line as a pure function of the conv's
spec, and where it holds the block runs through ``conv3x3x3`` (K1's plain
version here), elsewhere through ``conv_nd``.  The conversion round trip
is bitwise over every key.  The init law is held as in
``tests/test_torch_init.py``: every tensor of 1000 elements or more has
a std within 10% of its twin's in JAX's ``UNetTrainer.init_state``, and
every tensor JAX starts at zero (or at one) starts there in the port
(``init_state`` is the model's ``init`` in train mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import unet3d as jax_unet
from gfe_mamba_tpu.ops import blocks as jax_blocks
from gfe_mamba_torch.models import unet3d
from gfe_mamba_torch.models.dropout import Dropout, seed_dropout
from gfe_mamba_torch.ops import blocks
from gfe_mamba_torch.ops import conv3d as ops_conv
from gfe_mamba_torch.utils.convert import (jax_variables_from_state_dict,
                                           state_dict_from_jax)
from gfe_mamba_torch.utils.initializers import init_weights

torch.set_num_threads(2)
REL = 1e-4


def _draw(module, seed=0, order="gcr"):
    """Flax-law weights, then every 1-D parameter and running statistic
    moved off its init so that norms and biases are exercised; returns
    the JAX variables of the same weights."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen, "flax")
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return jax.tree_util.tree_map(
        jnp.asarray, jax_variables_from_state_dict(module.state_dict(),
                                                   order))


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rel=REL, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, (tag, err)


def _apply(jmod, variables, *args, train=False, **kw):
    """JAX forward; in train mode also the moved batch_stats."""
    if train:
        out, moved = jmod.apply(variables, *args, deterministic=False,
                                mutable=["batch_stats"], **kw)
        return out, moved.get("batch_stats", {})
    return jmod.apply(variables, *args, deterministic=True, **kw), None


def _check_stats(port, moved, order):
    if not moved:
        return
    want = jax_variables_from_state_dict(port.state_dict(), order)
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(moved)[0]}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(want["batch_stats"])[0]}
    assert set(flat) == set(got)
    for k in flat:
        _close(got[k], flat[k], tag=k)


@pytest.mark.parametrize("dims,k,pad,cin,cout,want", [
    (3, 3, 1, 8, 16, True), (3, 3, 1, 192, 64, True),
    (3, 3, (1, 1, 1), 64, 64, True),
    (3, 3, 1, 1, 32, False),      # the stem
    (3, 3, 1, 12, 16, False), (3, 3, 1, 16, 20, False),
    (2, 3, 1, 16, 16, False),     # 2D
    (3, 5, 2, 16, 16, False), (3, 3, 0, 16, 16, False),
    (3, 3, "SAME", 16, 16, False), (3, 1, 0, 16, 16, False)])
def test_conv_rule_on_both_sides_of_the_line(dims, k, pad, cin, cout, want):
    assert blocks.k1_eligible(dims, k, pad, cin, cout) is want
    conv = blocks.SingleConv(cin, cout, "gcr", 4, k, pad, dims=dims)
    assert conv.fused is want


def test_eligible_convs_run_through_the_fused_conv(monkeypatch):
    """A UNet3D at f_maps 16: its stem (C_in 1) runs through
    ``conv_nd``, the 5 other 3x3x3 convs through ``conv3x3x3``."""
    calls = {"fused": 0, "cudnn": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(blocks, "conv3x3x3",
                        count("fused", ops_conv.conv3x3x3))
    monkeypatch.setattr(blocks, "conv_nd", count("cudnn", ops_conv.conv_nd))
    model = unet3d.get_model(dict(name="UNet3D", f_maps=16, num_levels=2))
    with torch.no_grad():
        model(torch.zeros(1, 8, 8, 8, 1))
    assert calls == {"fused": 5, "cudnn": 1}


# orders: GN before / after the conv, BN (in eval and in train mode,
# which moves its statistics), every activation, dropout chars (identity
# in eval, p = 0 in train); the fused conv (8 -> 16), a C_in = 1 stem and
# 2D convs
_DOUBLE = [("gcr", 3, 8, 16, False), ("gcr", 3, 1, 4, False),
           ("gcr", 2, 4, 8, False), ("cgl", 3, 8, 16, False),
           ("cgl", 2, 4, 8, False), ("ce", 3, 8, 16, False),
           ("gcrd", 3, 8, 16, False), ("bce", 3, 8, 16, False),
           ("bce", 3, 8, 16, True), ("cbr", 3, 1, 4, True),
           ("cbr", 2, 4, 8, True), ("bcD", 3, 8, 16, True),
           ("bcD", 2, 4, 8, False)]


@pytest.mark.parametrize("order,dims,cin,cout,train", _DOUBLE)
def test_double_conv_matches_jax(order, dims, cin, cout, train):
    encoder = cin != 8          # the decoder's first conv goes to cout
    p = 0.0 if train else 0.1
    port = blocks.DoubleConv(cin, cout, encoder, order=order, num_groups=2,
                             dropout_prob=p, dims=dims)
    variables = _draw(port, order=order)
    jmod = jax_blocks.DoubleConv(cout, encoder, order=order, num_groups=2,
                                 dropout_prob=p, dims=dims)
    x = _x(2, *(6,) * dims, cin)
    want, moved = _apply(jmod, variables, jnp.asarray(x), train=train)
    port.train(train)
    got = port(torch.from_numpy(x))
    _close(got, want, tag=order)
    _check_stats(port, moved, order)


@pytest.mark.parametrize("kernel,pad", [(5, 2), (3, 0), (1, 0)])
def test_double_conv_other_kernels_match_jax(kernel, pad):
    port = blocks.DoubleConv(8, 16, True, kernel, "gcr", 2, pad)
    variables = _draw(port)
    jmod = jax_blocks.DoubleConv(16, True, kernel, "gcr", 2, pad)
    x = _x(1, 9, 9, 9, 8)
    want, _ = _apply(jmod, variables, jnp.asarray(x))
    _close(port.eval()(torch.from_numpy(x)), want)


@pytest.mark.parametrize("se,dims,cin,cout,order", [
    (None, 3, 8, 16, "gcr"), (None, 3, 16, 16, "cge"),
    (None, 3, 1, 8, "cbl"), (None, 2, 4, 8, "gcr"),
    ("scse", 3, 8, 16, "gcr"), ("scse", 2, 4, 8, "cbl"),
    ("cse", 3, 16, 16, "cge"), ("sse", 3, 1, 8, "gcr")])
def test_resnet_blocks_match_jax(se, dims, cin, cout, order):
    if se is None:
        port = blocks.ResNetBlock(cin, cout, order, 2, dims=dims)
        jmod = jax_blocks.ResNetBlock(cout, order=order, num_groups=2,
                                      dims=dims)
    else:
        port = blocks.ResNetBlockSE(cin, cout, order, 2, se, dims=dims)
        jmod = jax_blocks.ResNetBlockSE(cout, order=order, num_groups=2,
                                        se_module=se, dims=dims)
    variables = _draw(port, order=order)
    x = _x(2, *(5,) * dims, cin)
    want, _ = _apply(jmod, variables, jnp.asarray(x))
    _close(port.eval()(torch.from_numpy(x)), want)


@pytest.mark.parametrize("layer", ["cse", "sse", "scse"])
def test_se_layers_match_jax(layer):
    port = {"cse": blocks.ChannelSELayer(8, 2),
            "sse": blocks.SpatialSELayer(8),
            "scse": blocks.ChannelSpatialSELayer(8, 2)}[layer]
    jmod = {"cse": jax_blocks.ChannelSELayer(2),
            "sse": jax_blocks.SpatialSELayer(),
            "scse": jax_blocks.ChannelSpatialSELayer(2)}[layer]
    variables = _draw(port)
    x = _x(2, 4, 5, 3, 8)
    _close(port(torch.from_numpy(x)),
           jmod.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("pool_type,dims,basic", [
    ("max", 3, "DoubleConv"), ("avg", 2, "ResNetBlock"),
    ("avg", 3, "ResNetBlockSE")])
def test_encoder_matches_jax(pool_type, dims, basic):
    port = blocks.Encoder(8, 16, basic, pool_type=pool_type, num_groups=2,
                          dims=dims)
    jmod = jax_blocks.Encoder(16, basic, pool_type=pool_type, num_groups=2,
                              dims=dims)
    variables = _draw(port)
    x = _x(1, *(8,) * dims, 8)
    want, _ = _apply(jmod, variables, jnp.asarray(x))
    _close(port.eval()(torch.from_numpy(x)), want)


@pytest.mark.parametrize("basic,upsample,dims,z,exact", [
    ("DoubleConv", "default", 3, 4, False),     # nearest + concat
    ("ResNetBlock", "default", 3, 4, False),    # 2n deconv + sum
    ("ResNetBlock", "default", 3, 3, False),    # odd z: 2n - 1 + resize
    ("ResNetBlock", "default", 3, 4, True),     # exact_reference_upsample
    ("ResNetBlockSE", "default", 2, 4, False),  # 2D deconv + sum
    ("DoubleConv", "deconv", 3, 4, False),      # deconv + concat
    ("ResNetBlock", "nearest", 3, 3, False),    # nearest + concat
    ("DoubleConv", "trilinear", 3, 3, False),
    ("DoubleConv", "bilinear", 2, 3, False),
    ("DoubleConv", "cubic", 3, 3, False),
    ("DoubleConv", "lanczos3", 2, 3, False)])
def test_decoder_matches_jax(basic, upsample, dims, z, exact):
    port = blocks.Decoder(16, 8, basic, num_groups=2, upsample=upsample,
                          dims=dims, exact_reference_upsample=exact)
    jmod = jax_blocks.Decoder(8, basic, num_groups=2, upsample=upsample,
                              dims=dims, exact_reference_upsample=exact)
    variables = _draw(port)
    small = (3, 4, z)[:dims] if dims == 3 else (3, z)
    big = tuple(2 * s + (1 if i == 0 else 0) for i, s in enumerate(small))
    skip, x = _x(1, *big, 8, seed=2), _x(1, *small, 16, seed=3)
    want, _ = _apply(jmod, variables, jnp.asarray(skip), jnp.asarray(x))
    _close(port.eval()(torch.from_numpy(skip), torch.from_numpy(x)), want,
           tag=upsample)


# (config, input shape, JAX layer order); widths of 8 take the fused
# conv for every conv but a C_in = 1 stem, widths of 4 take conv_nd
_FAMILIES = [
    (dict(name="UNet3D", f_maps=8, num_levels=3, num_groups=2),
     (1, 8, 8, 8, 1)),
    (dict(name="UNet3D", f_maps=4, num_levels=2, num_groups=2,
          layer_order="cbr", dropout_prob=0.0), (2, 6, 6, 6, 1)),
    (dict(name="ResidualUNet3D", f_maps=8, num_levels=3, num_groups=2),
     (1, 8, 8, 8, 1)),
    (dict(name="ResidualUNetSE3D", f_maps=8, num_levels=2, num_groups=2,
          in_channels=2, out_channels=3, final_sigmoid=False),
     (1, 6, 6, 6, 2)),
    (dict(name="UNet2D", f_maps=4, num_levels=3, num_groups=2,
          out_channels=3, final_sigmoid=False), (2, 8, 8, 1)),
    (dict(name="ResidualUNet2D", f_maps=4, num_levels=3, num_groups=2),
     (1, 8, 8, 1)),
    (dict(name="Residual_mid_UNet3D", f_maps=(8, 16), num_groups=2,
          layer_order="cge"), (1, 8, 8, 6, 1)),
    (dict(name="UNet3D", f_maps=8, num_levels=2, num_groups=2,
          upsample="trilinear", conv_kernel_size=5, conv_padding=2,
          pool_kernel_size=3), (1, 9, 9, 9, 1)),
]


def _jax_model(cfg):
    cfg = {k: v for k, v in cfg.items() if k != "in_channels"}
    return jax_unet.get_model(cfg)


# every family in eval mode; in train mode the BatchNorm one, an SE one
# and a 2D one
_FAMILY_RUNS = [(c, s, False) for c, s in _FAMILIES] + [
    (*_FAMILIES[i], True) for i in (1, 3, 4)]


@pytest.mark.parametrize("cfg,shape,train", _FAMILY_RUNS, ids=[
    f"{c['name']}-{'train' if t else 'eval'}" for c, _, t in _FAMILY_RUNS])
def test_families_match_jax(cfg, shape, train):
    """Eval mode ends in the sigmoid / softmax, train mode does not (and
    moves the BatchNorm statistics); ``output_mid`` hands out the same
    skip and decoder features."""
    order = cfg.get("layer_order", "gcr")
    port = unet3d.get_model(cfg)
    variables = _draw(port, order=order)
    jmod = _jax_model(cfg)
    x = _x(*shape)
    mid = cfg["name"] == "Residual_mid_UNet3D"
    if train:
        want, moved = jmod.apply(variables, jnp.asarray(x), train=True,
                                 output_mid=mid, mutable=["batch_stats"])
        moved = moved.get("batch_stats", {})
    else:
        want, moved = jmod.apply(variables, jnp.asarray(x),
                                 output_mid=mid), {}
    port.train(train)
    got = port(torch.from_numpy(x), output_mid=mid)
    if mid:
        for g_list, w_list in zip(got[:2], want[:2]):
            assert len(g_list) == len(w_list)
            for g, w in zip(g_list, w_list):
                _close(g, w)
        got, want = got[2], want[2]
    _close(got, want, tag=cfg["name"])
    if not train and cfg.get("final_sigmoid", True):
        got = got.detach()
        assert 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
    _check_stats(port, moved, order)


@pytest.mark.parametrize("cfg,shape", _FAMILIES,
                         ids=[c["name"] for c, _ in _FAMILIES])
def test_convert_round_trip_is_bitwise(cfg, shape):
    port = unet3d.get_model(cfg)
    _draw(port, order=cfg.get("layer_order", "gcr"))
    state = port.state_dict()
    back = state_dict_from_jax(jax_variables_from_state_dict(
        state, cfg.get("layer_order", "gcr")))
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key


def test_remat_recomputes_the_same_gradients():
    """``remat`` (JAX's field): each block recomputed in the backward
    gives the gradients of the plain run, within f32 rounding."""
    cfg = dict(name="ResidualUNet3D", f_maps=8, num_levels=2, num_groups=2)
    x = torch.from_numpy(_x(1, 6, 6, 6, 1))
    grads = []
    for remat in (False, True):
        model = unet3d.get_model(dict(cfg, remat=remat), seed=4).train()
        model(x).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        _close(b, a.numpy(), 1e-6)


def test_get_model_names():
    """Both name sets build their class; the ViT generator under
    ``get_model`` ends in JAX's default eval sigmoid; unknown names
    raise."""
    small = dict(f_maps=(8, 16), num_groups=2)
    for name in ("UNet3D", "ResidualUNet3D", "ResidualUNetSE3D", "UNet2D",
                 "ResidualUNet2D", "Residual_mid_UNet3D",
                 "ResidualMidUNet3D"):
        model = unet3d.get_model(dict(name=name, **small))
        assert isinstance(model, unet3d.UNet) and not model.training
    kinds = {type(m.basic_module).__name__ for m in unet3d.get_model(
        dict(name="ResidualUNetSE3D", **small)).encoders}
    assert kinds == {"ResNetBlockSE"}
    vit = dict(f_maps=(8, 16), img_size=(16, 16, 8), fold_factor=2,
               vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2,
               vit_mlp_dim=32, unknown_key=1)
    for name in ("Residual_mid_UNet3D_vit", "ResidualMidUNet3DViT"):
        model = unet3d.get_model(dict(name=name, **vit))
        assert isinstance(model, unet3d.ResidualMidUNet3DViT)
        assert model.is_segmentation
        with torch.no_grad():
            out = model(torch.randn(1, 16, 16, 8, 1))
        assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    with pytest.raises(ValueError, match="unknown model"):
        unet3d.get_model(dict(name="NoSuchNet"))


def test_channel_dropout_drops_whole_channels():
    """'D': one draw per (batch, channel), shared by every voxel."""
    conv = blocks.SingleConv(4, 8, "cD", dropout_prob=0.5, dims=3)
    init_weights(conv, torch.Generator().manual_seed(0), "flax")
    seed_dropout(conv, torch.Generator().manual_seed(1))
    conv.train()
    out = conv(torch.rand(2, 4, 4, 4, 4) + 1.0)
    zero = (out == 0).reshape(2, -1, 8)
    assert torch.equal(zero.all(1), zero.any(1))
    assert 0 < int(zero.all(1).sum()) < 16
    assert isinstance(conv.dropout2d, Dropout)


@pytest.mark.parametrize("name,order", [("ResidualUNetSE3D", "gcr"),
                                        ("UNet3D", "bcr")])
def test_init_law_matches_jax_init_state(name, order):
    cfg = dict(name=name, f_maps=(16, 32), num_groups=4, layer_order=order,
               in_channels=1)
    jmod = _jax_model(cfg)
    # what JAX's UNetTrainer.init_state draws
    variables = jax.jit(lambda key: jmod.init(
        key, jnp.zeros((1, 8, 8, 8, 1)), train=True))(jax.random.key(0))
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    port = unet3d.get_model(cfg, seed=3).state_dict()
    assert set(port) == set(ref)
    checked = 0
    for key, want in ref.items():
        got, want = port[key].numpy(), want.numpy()
        if not want.any() or (want == 1).all():
            assert np.array_equal(got, want), key
        elif want.size >= 1000:
            checked += 1
            assert abs(got.std() / want.std() - 1.0) <= 0.10, key
    assert checked >= 4
