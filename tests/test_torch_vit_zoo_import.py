"""The four zoo importers: the port's ViT3D, SimpleViT3D, ViViT and CCT
(2D and 3D) carry the vendored reference's state_dict keys, which JAX's
``utils/torch_import.py`` importers read.

No reference checkpoint is needed: each port model draws its weights
(every 1-D parameter moved off its init), and its own state_dict, under
the reference's names, goes to JAX's ``import_vit3d`` /
``import_simple_vit3d`` / ``import_vivit`` / ``import_cct`` (which refuse
a flax parameter left unfilled); both models then run the same input,
logits within 1e-5 relative to max(1, max |JAX|).  The port's own
importers load the same dict into a fresh model bitwise; the reference's
other spellings (simple-vit's bias-free ``to_out`` and ``net.3``, CCT's
stored sine table) load into both packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.models import vit_zoo as jz
from gfe_mamba_tpu.models import vit_zoo_extra as jx
from gfe_mamba_tpu.utils import torch_import as ji
from gfe_mamba_torch.models import vit_zoo as pz
from gfe_mamba_torch.models import vit_zoo_extra as px
from gfe_mamba_torch.utils import torch_import as pi

torch.set_num_threads(2)
REL = 1e-5

VIT3D = dict(image_size=(16, 8), image_depth=12, patch_size=4,
             depth_patch_size=6, num_classes=3, dim=32, depth=2, heads=2,
             mlp_dim=40, dim_head=16)
SIMPLE3D = dict(image_size=(8, 16, 12), patch_size=(4, 8, 4), num_classes=3,
                dim=32, depth=2, heads=2, mlp_dim=40, dim_head=16)
VIVIT = dict(image_size=(16, 16), image_patch_size=(8, 8), frames=8,
             frame_patch_size=4, num_classes=3, dim=32, spatial_depth=1,
             temporal_depth=2, heads=2, mlp_dim=32, dim_head=16)
CCT2 = dict(num_classes=4, embedding_dim=16, num_layers=2, num_heads=2)

# name -> (make the port model, make the JAX model, JAX import, input shape)
CASES = {
    "vit3d": (lambda: pz.ViT3D(**VIT3D, channels=2),
              lambda: jz.ViT3D(**VIT3D),
              lambda sd, like: ji.import_vit3d(sd, like, (2, 4, 2)),
              pi.import_vit3d, (2, 16, 8, 12, 2)),
    "simple_vit3d": (lambda: px.SimpleViT3D(**SIMPLE3D, channels=2),
                     lambda: jx.SimpleViT3D(**SIMPLE3D),
                     lambda sd, like: ji.import_simple_vit3d(
                         sd, like, (8, 4, 4, 2)),
                     pi.import_simple_vit3d, (2, 8, 16, 12, 2)),
    "vivit": (lambda: px.ViViT(**VIVIT, channels=2),
              lambda: jx.ViViT(**VIVIT), ji.import_vivit, pi.import_vivit,
              (2, 8, 16, 16, 2)),
    "cct2d": (lambda: px.CCT(**CCT2, image_size=32),
              lambda: jx.CCT(**CCT2),
              lambda sd, like: ji.import_cct(sd, like, dims=2),
              pi.import_cct, (2, 32, 32, 3)),
    "cct3d": (lambda: px.CCT3D(**CCT2, image_size=16, frames=8, channels=1),
              lambda: jx.CCT3D(**CCT2),
              lambda sd, like: ji.import_cct(sd, like, dims=3),
              pi.import_cct, (2, 8, 16, 16, 1)),
    "cct2d-sine": (lambda: px.CCT(**CCT2, positional_embedding="sine",
                                  image_size=32),
                   lambda: jx.CCT(**CCT2, positional_embedding="sine"),
                   lambda sd, like: ji.import_cct(sd, like, dims=2),
                   pi.import_cct, (2, 32, 32, 3)),
}


def _port(make, seed):
    model = make()
    gen = torch.Generator().manual_seed(seed)
    pz.init_zoo(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _numpy(state_dict):
    return {k: v.detach().numpy() for k, v in state_dict.items()}


def _logits_match(make_jax, jax_import, sd, x, want, tag):
    jmod = make_jax()
    like = jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x))
    params = jax_import(sd, like["params"])
    got = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_state_dict_loads_into_jax_and_port(name):
    make, make_jax, jax_import, port_import, shape = CASES[name]
    port = _port(make, len(name))
    x = np.random.RandomState(len(name)).rand(*shape).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    sd = _numpy(port.state_dict())
    _logits_match(make_jax, jax_import, sd, x, want, name)
    fresh = _port(make, 99)
    assert port_import(sd, fresh) is fresh
    state = fresh.state_dict()
    assert sorted(state) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(state[key], torch.from_numpy(value)), key


def test_simple_vit3d_reference_flavour():
    """simple_vit_3d.py's own keys: a bias-free ``to_out`` Linear and the
    feed-forward's second Linear at ``net.3``; both importers zero-fill
    the bias."""
    make, make_jax, jax_import, port_import, shape = CASES["simple_vit3d"]
    port = _port(make, 5)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("to_out.0.bias"):
                p.zero_()
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    sd = {}
    for key, value in _numpy(port.state_dict()).items():
        if key.endswith("to_out.0.bias"):
            continue
        sd[key.replace("to_out.0.weight", "to_out.weight")
           .replace("net.4.", "net.3.")] = value
    assert any(k.endswith("to_out.weight") for k in sd)
    _logits_match(make_jax, jax_import, sd, x, want, "flavour")
    fresh = port_import(sd, _port(make, 6))
    for key, value in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_cct_stored_sine_table():
    """A reference checkpoint stores CCT's sine table: both importers
    check it against the table they recompute and drop it; another table
    is refused."""
    make, make_jax, jax_import, port_import, shape = CASES["cct2d-sine"]
    port = _port(make, 7)
    x = np.random.RandomState(7).rand(*shape).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    sd = _numpy(port.state_dict())
    table = port.classifier.positional_emb.numpy()
    sd["classifier.positional_emb"] = table
    _logits_match(make_jax, jax_import, sd, x, want, "sine")
    fresh = port_import(sd, _port(make, 8))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(x)).numpy(),
                                      want)
    sd["classifier.positional_emb"] = table + 0.1
    with pytest.raises(ValueError):
        port_import(sd, _port(make, 8))


def test_import_refuses_missing_and_extra_keys():
    make = CASES["vivit"][0]
    sd = _numpy(_port(make, 1).state_dict())
    missing = {k: v for k, v in sd.items() if k != "mlp_head.bias"}
    with pytest.raises(RuntimeError):
        pi.import_vivit(missing, _port(make, 2))
    with pytest.raises(RuntimeError):
        pi.import_vivit({**sd, "extra.weight": np.zeros(1, np.float32)},
                        _port(make, 2))
