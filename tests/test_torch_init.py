"""The port's init laws against the JAX trainers' ``init_state``, leaf by
leaf, at a tiny width on the CPU.

For the Stage-2 pipeline (``ClassifyTrainer(init=...)``) and for Stage
1's generator and discriminator (``GanTrainer(g_init=...)``), under
``"torch"`` and ``"flax"``: every tensor of 1000 elements or more has a
std within 10% of its JAX twin's (the draws differ, the laws must not;
at 1000 samples a std's relative spread is about 2%, so 10% is some five
spreads), and every tensor that JAX initialises to all zeros is all
zeros in the port.  The two deconvs' fan_in (27 x in-channels in JAX) is
the case that moved: torch's own law would draw them sqrt(2) wider.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from gfe_mamba_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual
from gfe_mamba_tpu.models.discriminator import \
    PatchDiscriminator as JaxPatchDiscriminator
from gfe_mamba_tpu.models.pipeline import build_gfe_mamba as jax_build
from gfe_mamba_tpu.models.unet3d import ResidualMidUNet3DViT as JaxGen
from gfe_mamba_tpu.training.classify_trainer import \
    ClassifyTrainer as JaxClassifyTrainer
from gfe_mamba_tpu.training.gan_trainer import GanTrainer as JaxGanTrainer
from gfe_mamba_torch.losses.perceptual import PerceptualLoss
from gfe_mamba_torch.models.discriminator import PatchDiscriminator
from gfe_mamba_torch.models.pipeline import build_gfe_mamba, build_generator
from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
from gfe_mamba_torch.training.gan_trainer import GanTrainer
from gfe_mamba_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

IMG = (16, 16, 8)
GEN = dict(f_maps=(8, 16, 32), fold_factor=2, vit_patch_size=4,
           vit_dim=16, vit_depth=1, vit_heads=2, vit_mlp_dim=32)
CLS = dict(categories=(3, 5, 2), num_continuous=4, dim=64, depth=1, heads=2,
           seq_length=2)
MIN_SIZE = 1000
STD_TOL = 0.10


def _compare(port: dict, ref: dict, tag: str) -> None:
    assert set(port) == set(ref), tag
    checked, bad = 0, []
    for key, want in ref.items():
        want = want.numpy()
        got = port[key].detach().float().numpy()
        assert got.shape == want.shape, (tag, key)
        if not want.any():
            if got.any():
                bad.append((key, "JAX all zero, port not"))
            continue
        if want.size >= MIN_SIZE:
            checked += 1
            ratio = got.std() / want.std()
            if abs(ratio - 1.0) > STD_TOL:
                bad.append((key, f"std port/JAX {ratio:.3f}"))
    assert not bad, (tag, bad)
    assert checked, tag


@pytest.mark.parametrize("law", ["torch", "flax"])
def test_pipeline_init_law_matches_jax(law):
    pipeline = jax_build(**CLS, **GEN)
    trainer = JaxClassifyTrainer(pipeline, init=law)
    state = jax.jit(lambda key: trainer.init_state(
        key, jnp.zeros((1, *IMG, 1)), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1, 4))))(jax.random.key(0))
    model = build_gfe_mamba(img_size=IMG, device="cpu", seed=0, **CLS, **GEN)
    ClassifyTrainer(model, device="cpu", init=law)
    _compare(model.state_dict(), state_dict_from_jax(state.params),
             f"pipeline {law}")


@pytest.mark.parametrize("law", ["torch", "flax"])
def test_stage1_init_law_matches_jax(law):
    trainer = JaxGanTrainer(
        JaxGen(1, 1, is_segmentation=False, **GEN),
        JaxPatchDiscriminator(num_layers_d=2, num_channels=4),
        JaxPerceptual(fake_3d_ratio=0.5), g_init=law)
    sample = jnp.zeros((1, *IMG, 1))
    state = jax.jit(lambda key: trainer.init_state(key, sample, sample))(
        jax.random.key(0))
    disc = PatchDiscriminator(2, 4)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    port = GanTrainer(build_generator(img_size=IMG, device="cpu", seed=0,
                                      **GEN),
                      disc, PerceptualLoss(0.5, device="cpu"), device="cpu",
                      g_init=law)
    _compare(port.generator.state_dict(),
             state_dict_from_jax(state.g_params), f"generator {law}")
    _compare(port.discriminator.state_dict(),
             state_dict_from_jax(state.d_params), f"discriminator {law}")


def test_deconv_fan_in_is_in_channels_times_window():
    """The decoder deconvs under the torch law: U(+-1/sqrt(27 I)), the
    in-channels fan the JAX law takes, not torch's 27 O."""
    gen = build_generator(img_size=IMG, device="cpu", seed=0, **GEN)
    for dec in gen.decoders:
        w = dec.upsampling.upsample.conv_transposed.weight
        bound = (27 * w.shape[0]) ** -0.5
        top = float(w.detach().abs().max())
        assert 0.9 * bound < top <= bound
