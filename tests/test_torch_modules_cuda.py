"""The modules no main path builds, and what closes the port, on the card
against the CPU, f32 with TF32 off: ResNet3D-101 and MVCSNet, Jamba-v0.1
from HF names, the DSB2018 path, the volumetric ops, the legacy
combiners; the public surface, ``generation_evaluation``, ``view_nii``
and the quality runs' paths.  Every test needs an NVIDIA GPU (``cuda``
marker) and skips without one; the file imports torch and the port
only::

    python -m pytest --noconftest -m cuda tests/test_torch_modules_cuda.py -q

A card-against-CPU error is relative to the CPU result's own largest
magnitude.
"""

import argparse
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from gfe_mamba_torch.testing import (CANONICAL_IMG, assert_close,
                                     materialized, plain_convs_on_card,
                                     yaml_text)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = CANONICAL_IMG
# Jamba-v0.1's published config (ai21labs/Jamba-v0.1 config.json: hidden
# 4096, intermediate 14336, 32 query and 8 key-value heads, 16 experts
# top-2, d_state 16, d_conv 4, expand 2, dt_rank 256, vocabulary 65536,
# RMSNorm eps 1e-6, untied head), cut in depth from 32 layers to one
# period: 8, attention at layer 4, experts on the odd layers, 7 Mamba
HF_JAMBA = dict(d_model=4096, n_layers=8, mlp_size=14336,
                num_attention_heads=32, num_key_value_heads=8,
                num_experts=16, num_experts_per_tok=2, d_state=16, d_conv=4,
                expand_factor=2, dt_rank=256, vocab_size=65536,
                rms_norm_eps=1e-6, tie_lm_weights=False)
HF_PROMPT = (2, 64)
# the port's JambaLM names -> HF's, in order (experts unstacked apart)
HF_NAMES = ((r"^embedding\.", "model.embed_tokens."),
            (r"^final_layernorm\.", "model.final_layernorm."),
            (r"^jamba\.layers\.", "model.layers."),
            (r"\.pre_moe_layernorm\.", ".pre_ff_layernorm."),
            (r"\.moe\.router\.", ".feed_forward.router."),
            (r"\.moe\.expert\.", ".feed_forward."),
            (r"\.B_layernorm\.", ".b_layernorm."),
            (r"\.C_layernorm\.", ".c_layernorm."))
# the small quality path's f32 conv levels (batch 8)
SMALL_LEVELS = (((32, 32, 16), 8), ((16, 16, 8), 16), ((8, 8, 4), 32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name,seed", [("ResNet3D-101", 161),
                                       ("MVCSNet", 162)])
def test_baseline_matches_the_cpu(cuda, name, seed):
    """ResNet3D-101 (Kinetics widths, one input channel, one logit) and
    MVCSNet at its defaults, eval, weights from a seed: the pooled
    features the head reads (2048 and 512 wide) card against CPU within
    1e-4 at batch 1 on 64x64x48; at batch 4 on the canonical volume the
    logits are finite."""
    from gfe_mamba_torch.models.mvcs import MVCSNet
    from gfe_mamba_torch.models.resnet3d import generate_model

    make = (MVCSNet if name == "MVCSNet" else
            lambda: generate_model(101, n_input_channels=1, n_classes=1))
    model = materialized(make, seed).eval()
    x = torch.randn(1, 64, 64, 48, 1,
                    generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        want = model.features(x)
    model.to(cuda)
    xb = torch.randn(4, *IMG, 1, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(seed))
    with torch.inference_mode():
        assert_close(model.features(x.to(cuda)), want, 1e-4, floor=0.0)
        logits = model(xb)
    assert logits.shape == (4, 1) and torch.isfinite(logits).all()


@torch.no_grad()
def _jamba_on_card(cfg, seed, device):
    """A ``JambaLM`` of ``cfg`` built on the card and drawn there from
    ``seed`` at the torch law's scales (``init_weights`` draws on the CPU,
    minutes at 13e9 parameters): U(-s, s), s = fan_in ^ -0.5, for every
    matrix, conv and bias (the stacked experts over their in axis), the
    embedding N(0, init_std), the norms 1, then the Mamba dt, A and D
    laws from a CPU generator."""
    from gfe_mamba_torch.models.jamba import JambaLM
    from gfe_mamba_torch.models.mamba import MambaBlock, RMSNorm
    from gfe_mamba_torch.utils.initializers import kernel_fan_in

    with torch.device("meta"):
        lm = JambaLM(cfg)
    lm.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = set()
    for mod in lm.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, RMSNorm):
                p.fill_(1.0)
            elif isinstance(mod, torch.nn.Embedding):
                p.normal_(0.0, mod.init_std, generator=gen)
            elif name.startswith("experts_") or name in ("weight", "bias"):
                s = (p.shape[1] if name.startswith("experts_")
                     else kernel_fan_in(mod)) ** -0.5
                p.uniform_(-s, s, generator=gen)
            else:
                assert isinstance(mod, MambaBlock), (name, type(mod))
            drawn.add(id(p))
    cpu_gen = torch.Generator().manual_seed(seed)
    for mod in lm.modules():
        if isinstance(mod, MambaBlock):
            mod.reset_ssm_parameters(cpu_gen)
    assert len(drawn) == len(list(lm.parameters()))
    return lm


def _hf_state_dict(state):
    """A ``JambaLM`` state dict under HF Jamba's names, each stacked
    expert tensor split into one view per expert (no copy)."""
    out = {}
    for key, value in state.items():
        m = re.fullmatch(r"jamba\.layers\.(\d+)\.moe\.experts_(\w+)", key)
        if m:
            for e, w in enumerate(value):
                out[f"model.layers.{m[1]}.feed_forward.experts.{e}."
                    f"{m[2]}_proj.weight"] = w.T
            continue
        for pattern, repl in HF_NAMES:
            key = re.sub(pattern, repl, key)
        out[key] = value
    return out


def test_jamba_v01_from_hf_names(cuda):
    """Jamba-v0.1's widths at one period of its layers (13.3e9 parameters,
    53 GB in f32), drawn on the card and copied to the host, handed under
    HF's names to ``import_jamba_hf`` into a ``JambaLM`` on the card:
    every tensor back bitwise; the logits of a 64-token prompt at batch 2
    within 1e-4 of a CPU ``JambaLM`` holding the host copy itself;
    ``generate`` of 16 tokens (top_k 1) the greedy argmax of the forward;
    K2 once per Mamba layer of the forward and of ``generate``'s prefill,
    and on the first layer's operands within 1e-5 of its plain version."""
    import gc

    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM, generate
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    from gfe_mamba_torch.utils.torch_import import import_jamba_hf

    cfg = JambaConfig(**HF_JAMBA)
    source = _jamba_on_card(cfg, 163, cuda)
    host = {k: v.cpu() for k, v in source.state_dict().items()}
    del source
    torch.cuda.empty_cache()
    with torch.device("meta"):
        lm = JambaLM(cfg)
    lm.to_empty(device=cuda)
    import_jamba_hf(_hf_state_dict(host), lm).eval()
    for key, value in lm.state_dict().items():
        assert torch.equal(value, host[key].to(cuda)), key
    with torch.device("meta"):
        cpu = JambaLM(cfg)
    cpu.load_state_dict(host, assign=True)
    cpu.eval()
    prompt = torch.randint(0, cfg.vocab_size, HF_PROMPT,
                           generator=torch.Generator().manual_seed(164))
    with torch.inference_mode():
        want = cpu(prompt)[0]
    del cpu, host
    gc.collect()
    k2.launches = 0
    with torch.inference_mode():
        got = lm(prompt.to(cuda))[0]
    torch.cuda.synchronize()
    launches = k2.launches
    tokens = generate(lm, prompt.to(cuda), 16,
                      torch.Generator(device=cuda).manual_seed(165), top_k=1)
    torch.cuda.synchronize()
    assert_close(got, want, 1e-4, floor=0.0)
    scans = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    assert (launches, k2.launches - launches) == (scans, scans)
    with torch.inference_mode():
        greedy = lm(tokens)[0][:, HF_PROMPT[1] - 1:-1].argmax(-1)
        assert torch.equal(greedy, tokens[:, HF_PROMPT[1]:])
        layer = lm.jamba.layers[0]
        args = layer.mamba.scan_operands(
            layer.input_layernorm(lm.embedding(prompt.to(cuda))))
        assert_close(k2.selective_scan_cuda(*args, delta_softplus=True),
                     k2.selective_scan_plain(*args, delta_softplus=True),
                     1e-5)


def test_dsb2018_through_unet2d(cuda, tmp_path):
    """8 RGBA PNGs of 256x256 and their masks through ``DSB2018Dataset``,
    ``UNet2D`` at the JAX package's defaults on the card, ``dsb_predict``'s
    files read back by ``data/h5.py``: the predictions within 1e-4 of the
    CPU's, each file's segmentation that of its own predictions."""
    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.data.png import write_png
    from gfe_mamba_torch.models.unet3d import get_model
    from gfe_mamba_torch.segmentation.dsb import DSB2018Dataset
    from gfe_mamba_torch.segmentation.predictor import (dsb_predict,
                                                        pmaps_to_segmentation)

    root, size, images = str(tmp_path), (256, 256), 8
    rng = np.random.default_rng(166)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[:size[0], :size[1]]
    for i in range(images):
        blobs = np.zeros(size, bool)
        for cy, cx, r in zip(*(rng.integers(0, n, 12) for n in size),
                             rng.integers(6, 20, 12)):
            blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        rgba = rng.integers(0, 60, size + (4,))
        rgba[blobs, :3] += 150
        rgba[..., 3] = 255
        write_png(os.path.join(root, "images", f"{i:02d}.png"), rgba)
        write_png(os.path.join(root, "masks", f"{i:02d}.png"),
                  blobs.astype(np.uint8) * 255)
    data = DSB2018Dataset(root, "train")
    items = [data[i] for i in range(len(data))]
    batch = np.stack([item["raw"] for item in items])
    assert batch.shape == (images, *size, 1)
    assert all("label" in item for item in items)
    model = get_model(dict(name="UNet2D", in_channels=1, out_channels=1),
                      seed=167)
    with torch.inference_mode():
        want = model(torch.from_numpy(batch)).numpy()
    model.to(cuda)

    def predict(x):
        with torch.inference_mode():
            return model(torch.from_numpy(x).to(cuda)).cpu().numpy()

    out_dir = os.path.join(root, "predictions")
    os.makedirs(out_dir)
    files = dsb_predict(predict, [(batch, [os.path.join(
        root, "images", item["name"]) for item in items])], out_dir)
    preds = np.stack([h5.read(f, "predictions") for f in files])
    assert_close(torch.from_numpy(preds), torch.from_numpy(want[..., 0]),
                 1e-4, floor=0.0)
    for f, pred in zip(files, preds):
        seg = h5.read(f, "segmentation")
        assert seg.dtype == np.uint16, f
        assert np.array_equal(seg, pmaps_to_segmentation(pred)), f


def test_volumetric_ops_match_the_cpu(cuda):
    """On a 256x256x170 volume (an ellipsoid of tissue in noise with
    negatives): ``adaptive_normal``, ``foreground_bbox_jax`` (the box
    exactly the CPU's) and ``crop_resize`` to 160x160x96, the box and the
    crop also under CUDA's sync debug mode set to raise (no host sync),
    and a downsampling ``resize_volume``, each within 1e-5 of the CPU."""
    from gfe_mamba_torch.ops import volumetric as vol

    shape = (256, 256, 170)
    g = torch.Generator().manual_seed(168)
    grid = torch.meshgrid(*(torch.linspace(-1.0, 1.0, n) for n in shape),
                          indexing="ij")
    head = (grid[0] / 0.7) ** 2 + (grid[1] / 0.8) ** 2 \
        + (grid[2] / 0.6) ** 2 < 1.0
    img = torch.where(head, 400.0 + 400.0 * torch.rand(shape, generator=g),
                      0.0) + 5.0 * torch.randn(shape, generator=g)

    def pipeline(x):
        norm = vol.adaptive_normal(x)
        start, stop = vol.foreground_bbox_jax(x, 100.0)
        return (norm, start, stop, vol.crop_resize(norm, start, stop, IMG),
                vol.resize_volume(norm, IMG))

    want = pipeline(img)
    x = img.to(cuda)
    got = pipeline(x)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start, stop = vol.foreground_bbox_jax(x, 100.0)
        vol.crop_resize(got[0], start, stop, IMG)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    for i in (0, 3, 4):
        assert_close(got[i], want[i], 1e-5, floor=0.0, name=str(i))


def test_legacy_combiners_match_the_cpu(cuda):
    """The legacy combiners at the canonical generator's skip shapes
    (batch 1) and ``PatchDiscriminator(dims=2)`` (3 layers, 32 channels)
    on 256x256 at batch 4, card against CPU within 1e-4."""
    from gfe_mamba_torch.models import combiners as comb
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator

    g = torch.Generator().manual_seed(169)
    skips = ((IMG, 64), (tuple(n // 2 for n in IMG), 128))
    enc = [torch.randn(1, *s, c, generator=g) for s, c in skips]
    dec = [torch.randn(1, *s, c, generator=g) for s, c in skips]
    # the fused head's external token, as wide as the pyramid descriptor
    width = comb.CombineClassifierFused(spatial=IMG).fully_con.in_features
    ft = torch.randn(1, 1, width // 2, generator=g)
    cases = ((lambda: comb.CombineClassifier(spatial=IMG), ()),
             (lambda: comb.CombineClassifierFused(spatial=IMG), (ft,)),
             (comb.CombineClassifier2, ()), (comb.CombineClassifier3, ()),
             (comb.CombineClassifierCross, ()),
             (comb.CombineClassifierEmb, ()))
    enc_c, dec_c = [t.to(cuda) for t in enc], [t.to(cuda) for t in dec]
    for i, (make, extra) in enumerate(cases):
        model = materialized(make, seed=170 + i).eval()
        with torch.inference_mode():
            want = model(enc, dec, *extra)
        model.to(cuda)
        with torch.inference_mode():
            got = model(enc_c, dec_c, *[t.to(cuda) for t in extra])
        assert_close(got, want, 1e-4, floor=0.0, name=str(i))
    disc = PatchDiscriminator(3, 32, dims=2)
    disc.reset_parameters(torch.Generator().manual_seed(176))
    x = torch.randn(4, 256, 256, 1, generator=g)
    with torch.inference_mode():
        want = disc(x)
    disc.to(cuda)
    with torch.inference_mode():
        got = disc(x.to(cuda))
    for i, (a, b) in enumerate(zip(got, want)):
        assert_close(a, b, 1e-4, floor=0.0, name=f"feature {i}")


def test_public_surface_and_linear_recurrence(cuda):
    """Every name of the nine ``__init__.py`` files' re-exports resolves
    (89 names and ``config``), and ``ops.scan.linear_recurrence`` at (4,
    53, 1024) f32 in both modes is within 1e-5 of the CPU."""
    import importlib

    import gfe_mamba_torch
    from gfe_mamba_torch.ops.scan import linear_recurrence

    names = 0
    for sub in ("models", "ops", "data", "parallel", "segmentation",
                "training", "utils", "losses"):
        pkg = importlib.import_module(f"gfe_mamba_torch.{sub}")
        for name in pkg.__all__:
            getattr(pkg, name)
            names += 1
    getattr(gfe_mamba_torch, "config")
    assert names + 1 == 90
    g = torch.Generator().manual_seed(190)
    coeffs = torch.rand(4, 53, 1024, generator=g) * 0.5 + 0.5
    values = torch.randn(4, 53, 1024, generator=g)
    for mode in ("associative", "sequential"):
        assert_close(linear_recurrence(coeffs.to(cuda), values.to(cuda),
                                       mode=mode),
                     linear_recurrence(coeffs, values, mode=mode), 1e-5,
                     floor=0.0, name=mode)


def _eval_tree(root, cf, subjects):
    from gfe_mamba_torch.data.synthetic import make_mri2pet_tree

    return make_mri2pet_tree(os.path.join(root, "tree"), n_subjects=subjects,
                             shape=tuple(cf["img_sz"]), seed=19)


def test_generation_evaluation_matches_the_cpu(cuda, tmp_path):
    """``cli/generation_evaluation`` (f32) over 2 batches of a synthetic
    160x160x96 tree with the canonical generator of
    ``configs/main_gan_vit_config.yaml`` from a seeded npz: K1 10 times
    per batch; the first batch's PSNR and MSE against the same tool on
    the CPU within twice the relative distance of a witness run on the
    card with the plain convs (the random generator's relu masks flip
    between two f32 devices), and within 1e-3; one PNG per batch."""
    from gfe_mamba_torch.cli import generation_evaluation
    from gfe_mamba_torch.cli.common import generator_kwargs
    from gfe_mamba_torch.config import load_config
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.training.checkpoint import save_params_npz

    root, batches = str(tmp_path), 2
    cf = dict(load_config(os.path.join(REPO, "configs",
                                       "main_gan_vit_config.yaml")))
    cf["eval_path"] = _eval_tree(root, cf, batches * cf["eval_bc"])
    config = os.path.join(root, "gen_eval.yaml")
    with open(config, "w") as f:
        f.write(yaml_text(cf))
    ckpt = os.path.join(root, "generator.npz")
    save_params_npz(ckpt, build_generator(
        seed=19, device="cpu", **generator_kwargs(cf, remat_default=False)))

    def run(device, n, out):
        return generation_evaluation.main(argparse.Namespace(
            config_path=config, ckpt=ckpt, num_batches=n,
            out_dir=os.path.join(root, out), device=device))

    k1.launches = 0
    got = run(None, batches, "card")
    assert k1.launches == 10 * batches
    with plain_convs_on_card():
        witness = run(None, 1, "witness")
    want = run("cpu", 1, "cpu")
    for key in ("psnr", "mse"):
        a, w, b = got[key][0], witness[key][0], want[key][0]
        assert math.isfinite(a), key
        assert abs(a - b) / abs(b) <= max(1e-3, 2 * abs(w - b) / abs(b)), \
            (key, a, w, b)
    assert sorted(os.listdir(os.path.join(root, "card"))) == \
        [f"{i + 1}.png" for i in range(batches)]


def test_view_nii(cuda, tmp_path):
    """``cli/view_nii --normalize`` on one written 160x160x96 NIfTI: the
    PNG decodes to the grid computed here, exactly."""
    from gfe_mamba_torch.cli import view_nii
    from gfe_mamba_torch.data.nifti import load_nifti
    from gfe_mamba_torch.data.png import read_png
    from gfe_mamba_torch.utils.experiment import volume_grid

    tree = _eval_tree(str(tmp_path), dict(img_sz=list(IMG)), 1)
    volume = os.path.join(tree, sorted(os.listdir(tree))[0], "mri.nii.gz")
    out = view_nii.main(view_nii.parse_args(
        [volume, "--out", str(tmp_path / "view.png"), "--normalize"]))
    vol = load_nifti(volume)[0]
    lo, hi = np.percentile(vol, [1, 99])
    vol = np.clip((vol - lo) / max(hi - lo, 1e-9), 0, 1) * 2 - 1
    want = (volume_grid(vol) * 255).astype(np.uint8)
    got = read_png(out)[0][..., 0]
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("geometry", ["small", "canonical"])
def test_quality_smoke_launches_every_kernel(cuda, tmp_path, geometry):
    """``quality_torch.py --smoke`` at the small geometry (f32) and the
    canonical one (160x160x96, bf16): K1, K1 as dz (read inside the conv
    Function's backward), K3, K2 and K4 each launch, and the artifact is
    the smoke run's.  At the small geometry K2 and K4 (f32) also hold to
    their plain versions at the scan shape its Stage 2 gave (1e-4 of the
    plain result's largest magnitude)."""
    import quality_torch
    from gfe_mamba_torch.ops import conv3d, scan
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    shapes, dz = [], [0]
    kernel, backward = scan.selective_scan_cuda, conv3d.Conv3x3x3Fn.backward

    def recording(x, *args, **kwargs):
        shapes.append(tuple(x.shape) + (args[1].shape[1],))
        return kernel(x, *args, **kwargs)

    def counted(ctx, g):
        before = k1.launches
        out = backward(ctx, g)
        dz[0] += k1.launches - before
        return out

    path = str(tmp_path / f"{geometry}.json")
    scan.selective_scan_cuda = recording
    conv3d.Conv3x3x3Fn.backward = staticmethod(counted)
    try:
        k1.launches = k1.dw_launches = k2.launches = k2.bwd_launches = 0
        quality_torch.main(["--geometry", geometry, "--smoke", "--out",
                            path])
    finally:
        scan.selective_scan_cuda = kernel
        conv3d.Conv3x3x3Fn.backward = staticmethod(backward)
    counts = {"K1": k1.launches - dz[0], "K1-dz": dz[0], "K3": k1.dw_launches,
              "K2": k2.launches, "K4": k2.bwd_launches}
    assert all(n > 0 for n in counts.values()), counts
    with open(path) as f:
        assert json.load(f)["config"]["smoke"] is True
    if geometry == "small":
        bsz, L, ED, N = shapes[0]
        gen = torch.Generator(device=cuda).manual_seed(19)

        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=cuda) * scale

        args = [r(bsz, L, ED), r(bsz, L, ED, scale=0.5), -r(ED, N).abs(),
                r(bsz, L, N), r(bsz, L, N), r(ED), r(bsz, L, ED),
                r(ED, scale=0.1)]
        g = r(bsz, L, ED)
        assert_close(k2.selective_scan_cuda(*args, delta_softplus=True),
                     k2.selective_scan_plain(*args, delta_softplus=True),
                     1e-4, floor=0.0)
        got = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
        want = k2.selective_scan_bwd_plain(*args, g, delta_softplus=True)
        for name, a, b in zip(("dx", "ddelta", "dA", "dB", "dC", "dD", "dz",
                               "dbias"), got, want):
            assert_close(a, b, 1e-4, floor=0.0, name=name)


@pytest.mark.parametrize("spatial,C", SMALL_LEVELS)
def test_kernels_at_the_small_quality_levels(cuda, spatial, C):
    """K1 (with and without the residual epilogue), K1 as dz and K3, f32,
    at a conv level of the small quality path (batch 8), within 1e-4 of
    the plain result's largest magnitude."""
    from gfe_mamba_torch.ops.cuda import conv3d as k1

    gen = torch.Generator(device=cuda).manual_seed(19)
    shape = (8, *spatial)
    x = torch.randn(*shape, C, generator=gen, device=cuda)
    w = torch.randn(3, 3, 3, C, C, generator=gen, device=cuda) \
        * (27 * C) ** -0.5
    a = torch.rand(8, C, generator=gen, device=cuda) + 0.5
    s = torch.randn(8, C, generator=gen, device=cuda)
    res = torch.randn(*shape, C, generator=gen, device=cuda)
    for act, r, post in (("relu", None, "none"), ("none", res, "relu")):
        args = (x, w, None, a, s, r, act, post)
        assert_close(k1.conv3x3x3_cuda(*args), k1.conv3x3x3_plain(*args),
                     1e-4, floor=0.0, name=act)
    wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    assert_close(k1.conv3x3x3_cuda(res, wf), k1.conv3x3x3_plain(res, wf),
                 1e-4, floor=0.0, name="dz")
    assert_close(k1.conv3x3x3_dw_cuda(x, res, a, s),
                 k1.conv3x3x3_dw_plain(x, res, a, s), 1e-4, floor=0.0,
                 name="dw")
