"""The ViT zoo (``models/vit_zoo*.py``), its importers and
``data/augment2d.py`` on the card against the CPU, f32 with TF32 off, at
the widths of upstream vit-pytorch's README examples (the card-against-CPU
checks at a smaller batch or volume, never at smaller widths or depths).
Every test needs an NVIDIA GPU (``cuda`` marker) and skips without one;
the file imports torch and the port only::

    python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py -q

Each output and gradient is held within 1e-4 of the CPU's own largest
magnitude (integer and boolean outputs exactly); at the batch a user
runs (32 images, or 4 volumes of 96x160x160) the outputs are finite.
"""

import contextlib
import copy

import pytest
import torch

from gfe_mamba_torch.testing import assert_close

pytestmark = pytest.mark.cuda

BATCH, PARITY_BATCH, SSL_PARITY_BATCH = 32, 2, 4
VOLUME, VOLUME_BATCH, PARITY_VOLUME = (96, 160, 160), 4, (48, 64, 64)
VITB = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024,
            depth=6, heads=16, mlp_dim=2048)
P16 = dict(VITB, patch_size=16)
I256, I224 = (256, 256, 3), (224, 224, 3)
CCT = dict(embedding_dim=384, n_conv_layers=2, kernel_size=7, stride=2,
           num_layers=14, num_heads=6, mlp_ratio=3.0)
MAXVIT = dict(num_classes=1000, dim_conv_stem=64, dim=96, dim_head=32,
              depth=(2, 2, 5, 2), window_size=7, mbconv_expansion_rate=4,
              mbconv_shrinkage_rate=0.25)
VIT1024 = dict(image_size=256, num_classes=1000, dim=1024, depth=6,
               heads=16, mlp_dim=2048)
# the 2D and 1D members of the zoo's first half: name -> (make(z, x, s,
# Transformer) over vit_zoo, vit_zoo_extra, vit_zoo_simple and
# models/vit.py's Transformer, input shape without the batch, train
# mode); each README example's widths on the JAX fields
FIRST_HALF = {
    "ClassifierViT": (lambda z, x, s, T: z.ClassifierViT(**VITB), I256),
    "SimpleViT": (lambda z, x, s, T: z.SimpleViT(**VITB), I256),
    "DeepViT": (lambda z, x, s, T: x.DeepViT(**VITB), I256),
    "SimpleViTQKNorm": (lambda z, x, s, T: s.SimpleViTQKNorm(**VITB), I256),
    "SimpleViTRegisterTokens": (lambda z, x, s, T: s.SimpleViTRegisterTokens(
        **VITB, num_register_tokens=4), I256),
    "SimpleViTFFT": (lambda z, x, s, T: s.SimpleViTFFT(
        **VITB, freq_patch_size=32), I256),
    "SimpleFlashAttnViT": (lambda z, x, s, T: s.SimpleFlashAttnViT(**VITB),
                           I256),
    "SimpleViTPatchDropout": (lambda z, x, s, T: s.SimpleViTPatchDropout(
        **VITB, patch_dropout=0.5), I256, True),
    "ViTPatchDropout": (lambda z, x, s, T: s.ViTPatchDropout(
        **VITB, patch_dropout=0.25), I256),
    "ParallelViT": (lambda z, x, s, T: s.ParallelViT(
        **dict(VITB, heads=8), num_parallel_branches=2), I256),
    "ViTForSmallDataset": (lambda z, x, s, T: s.ViTForSmallDataset(**P16),
                           I256),
    "LocalViT": (lambda z, x, s, T: s.LocalViT(**P16), I256),
    "CaiT": (lambda z, x, s, T: x.CaiT(**dict(VITB, depth=12), cls_depth=2),
             I256),
    "ViTWithPatchMerger": (lambda z, x, s, T: s.ViTWithPatchMerger(
        **dict(P16, depth=12, heads=8), patch_merge_layer=6,
        patch_merge_num_tokens=8), I256),
    "EfficientViT": (lambda z, x, s, T: s.EfficientViT(
        224, 32, 1000, 512, T(512, 12, 8, 64, 2048)), I224),
    "PiT": (lambda z, x, s, T: x.PiT(224, 14, 1000, 256, (3, 3, 3),
                                     (16, 16, 16), 2048), I224),
    "T2TViT": (lambda z, x, s, T: x.T2TViT(224, 1000, 512, 5, 8, 512), I224),
    "CrossViT": (lambda z, x, s, T: x.CrossViT(
        256, 1000, sm_patch_size=16, lg_patch_size=64, sm_dim=192,
        lg_dim=384, sm_enc_depth=2, lg_enc_depth=3, cross_attn_depth=2,
        multi_scale_enc_depth=4, heads=8, dim_head=64), I256),
    "CvT": (lambda z, x, s, T: x.CvT(1000, depths=(1, 2, 10)), I224),
    "NesT": (lambda z, x, s, T: x.NesT(224, 4, 1000, 96, 3, 3, (2, 2, 8)),
             I224),
    "MobileViT": (lambda z, x, s, T: x.MobileViT(
        (256, 256), (96, 120, 144),
        (16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384), 1000), I256),
    "CCT": (lambda z, x, s, T: x.CCT(1000, **CCT, image_size=224), I224),
    "SimpleViT1D": (lambda z, x, s, T: s.SimpleViT1D(
        256, 16, 1000, 1024, 6, 8, 2048), (256, 3)),
    "ViT1D": (lambda z, x, s, T: s.ViT1D(256, 16, 1000, 1024, 6, 8, 2048),
              (256, 3)),
}
# the image classifiers of the second half: name -> (make(h, f) over
# vit_zoo_hier and vit_zoo_final, input shape without the batch)
SECOND_HALF = {
    "LeViT": (lambda h, f: h.LeViT(224, 1000, (256, 384, 512), 4, (4, 6, 8),
                                   mlp_mult=2), I224),
    "MaxViT": (lambda h, f: h.MaxViT(**MAXVIT), I224),
    "TwinsSVT": (lambda h, f: h.TwinsSVT(1000), I224),
    "XCiT": (lambda h, f: h.XCiT(256, 32, 1000, 1024, 12, 2, 16, 2048), I256),
    "CrossFormer": (lambda h, f: h.CrossFormer(1000), I224),
    "RegionViT": (lambda h, f: h.RegionViT(1000), I224),
    "ScalableViT": (lambda h, f: h.ScalableViT(
        1000, 64, (2, 2, 20, 2), (2, 4, 8, 16), (8, 4, 2, 1),
        (64, 32, None, None)), I256),
    "SepViT": (lambda h, f: h.SepViT(1000, 32, (1, 2, 6, 2), (1, 2, 4, 8), 7,
                                     32, image_size=224), I224),
    "MaxViTWithRegisters": (lambda h, f: f.MaxViTWithRegisters(
        **MAXVIT, num_register_tokens=4), I224),
    "RvT": (lambda h, f: f.RvT(patch_size=32, **VIT1024), I256),
    "MemoryAdapter": (lambda h, f: f.MemoryAdapter(f.MemoryViT(
        256, 16, 1000, 1024, 6, 8, 2048), 5, 2), I256),
}
# the 3D members over a (D, H, W) volume with one channel: name ->
# (make(z, x, d, h, w), whether it reads (B, H, W, D, C), its importer)
VOLUME_MODELS = {
    "ViT3D": (lambda z, x, d, h, w: z.ViT3D(
        (h, w), d, 16, 16, 1000, 1024, 6, 8, 2048, channels=1), True,
        "import_vit3d"),
    "SimpleViT3D": (lambda z, x, d, h, w: x.SimpleViT3D(
        (d, h, w), (16, 16, 16), 1000, 1024, 6, 8, 2048, channels=1), False,
        "import_simple_vit3d"),
    "ViViT": (lambda z, x, d, h, w: x.ViViT(
        (h, w), (16, 16), d, 16, 1000, 1024, 6, 6, 8, 2048, channels=1),
        False, "import_vivit"),
    "CCT3D": (lambda z, x, d, h, w: x.CCT3D(
        num_classes=1000, **CCT, frame_kernel_size=3, image_size=(h, w),
        frames=d, channels=1), False, "import_cct"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def _no_default_init():
    """torch's own init of Linear, conv and LayerNorm skipped while a model
    is built (its weights are drawn afterwards)."""
    from torch.nn.modules.conv import _ConvNd

    classes = (torch.nn.Linear, _ConvNd, torch.nn.LayerNorm)
    saved = [c.reset_parameters for c in classes]
    for c in classes:
        c.reset_parameters = lambda self: None
    try:
        yield
    finally:
        for c, fn in zip(classes, saved):
            c.reset_parameters = fn


def _zoo_model(make, seed):
    """``make()`` on the CPU, its weights drawn from ``seed``."""
    from gfe_mamba_torch.models.vit_zoo import init_zoo

    with _no_default_init():
        model = make()
    return init_zoo(model, torch.Generator().manual_seed(seed))


def _close(got, want):
    """Each output (tuples flattened) within 1e-4 of the CPU's largest
    magnitude, integer and boolean ones equal."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, tuple):
            _close(a, b)
        elif a.dtype == torch.bool or not a.is_floating_point():
            assert torch.equal(a.cpu(), b), i
        else:
            assert_close(a, b, 1e-4, floor=0.0, name=str(i))


def _finite(model, call, inputs):
    """``call(model, *inputs)`` on the card: every floating output
    finite; the outputs."""
    with torch.inference_mode():
        out = call(model, *inputs)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t).all() for t in outs
               if t.is_floating_point())
    return out


@pytest.mark.parametrize("name", list(FIRST_HALF))
def test_first_half_classifier_matches_the_cpu(cuda, name):
    """Pooled features and logits at batch 2, weights from a seed on the
    CPU copied to the card (``SimpleViTPatchDropout`` in train mode, the
    parity's patch scores drawn once on the CPU and shared); at batch 32,
    drawing from a CUDA generator, the logits finite and (32, 1000)."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x
    from gfe_mamba_torch.models import vit_zoo_simple as s
    from gfe_mamba_torch.models.dropout import seed_dropout
    from gfe_mamba_torch.models.vit import Transformer

    make, shape, *train = FIRST_HALF[name]
    seed = 180 + list(FIRST_HALF).index(name)
    model = _zoo_model(lambda: make(z, x, s, Transformer), seed)
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand(PARITY_BATCH, *shape, generator=g)
    if train:
        drop = model.train().patch_dropout
        scores = torch.randn(PARITY_BATCH, model.pos.shape[0], generator=g)
        drop.scores = lambda rows, n, device: scores.to(device)
        seed_dropout(model, g)
    else:
        model.eval()
    with torch.inference_mode():
        want = model.features(xs), model(xs)
    model.to(cuda)
    with torch.inference_mode():
        got = model.features(xs.to(cuda)), model(xs.to(cuda))
    _close(got, want)
    cuda_gen = torch.Generator(device=cuda).manual_seed(seed)
    if train:
        del drop.scores
        seed_dropout(model, cuda_gen)
    xb = torch.rand(BATCH, *shape, device=cuda, generator=cuda_gen)
    assert _finite(model, lambda m, v: m(v), (xb,)).shape == (BATCH, 1000)


@pytest.mark.parametrize("name", list(VOLUME_MODELS))
def test_volume_model_imports_onto_the_card(cuda, name):
    """A 3D member at 48x64x64 (batch 1) drawn on the CPU, its state_dict
    (the reference's names) loaded by its importer onto a model on the
    card: features and logits against the CPU; the model at 96x160x160
    gives finite (4, 1000) logits at batch 4."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x
    from gfe_mamba_torch.utils import torch_import

    make, hwd, importer = VOLUME_MODELS[name]
    seed = 185 + list(VOLUME_MODELS).index(name)
    model = _zoo_model(lambda: make(z, x, *PARITY_VOLUME), seed).eval()
    xs = torch.rand(1, *PARITY_VOLUME, 1,
                    generator=torch.Generator().manual_seed(seed))
    if hwd:
        xs = xs.permute(0, 2, 3, 1, 4)
    with torch.inference_mode():
        want = model.features(xs), model(xs)
    with _no_default_init():
        card_model = make(z, x, *PARITY_VOLUME).to(cuda).eval()
    getattr(torch_import, importer)(model.state_dict(), card_model)
    with torch.inference_mode():
        got = card_model.features(xs.to(cuda)), card_model(xs.to(cuda))
    _close(got, want)
    del model, card_model
    xb = torch.rand(VOLUME_BATCH, *VOLUME, 1, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(seed))
    if hwd:
        xb = xb.permute(0, 2, 3, 1, 4)
    model = _zoo_model(lambda: make(z, x, *VOLUME), seed).to(cuda).eval()
    assert _finite(model, lambda m, v: m(v), (xb,)).shape == \
        (VOLUME_BATCH, 1000)


def _loss_and_grads(model, step, xs):
    """A loss and its backward on the CPU and on the card from the same
    weights, inputs and draws: the loss and every gradient within 1e-4 of
    the CPU's own largest magnitude; a parameter the loss does not reach
    (MP3's ViT head) has no gradient on either side."""
    loss = step(model, xs)
    loss.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.to("cuda")
    got_loss = step(model, xs.to("cuda"))
    got_loss.backward()
    assert_close(got_loss, loss, 1e-4, floor=0.0, name="loss")
    for key, p in model.named_parameters():
        assert (key in want) == (p.grad is not None), key
        if key in want:
            assert_close(p.grad, want[key], 1e-4, floor=0.0, name=key)


@pytest.mark.parametrize("name", ["MAE", "MPP", "DINO"])
def test_ssl_loss_matches_the_cpu(cuda, name):
    """MAE and MPP (the ViT-1024 trunk; MAE's decoder 512 wide, 6 deep)
    with the masking draws shared, and DINO's head (hidden 256, out
    65536) under ``dino_loss``, at batch 4; ``ema_update`` within 1e-6."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x

    seed = 190 + ["MAE", "MPP", "DINO"].index(name)
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device=cuda).manual_seed(seed)
    img = torch.rand(SSL_PARITY_BATCH, 256, 256, 3, generator=g)

    def with_gen(m, v):
        return m(v, cuda_gen if v.is_cuda else g)

    if name == "MAE":
        model = _zoo_model(lambda: z.MAE(
            256, 32, 1024, 6, 16, 2048, masking_ratio=0.75, decoder_dim=512,
            decoder_depth=6, decoder_heads=8), seed)
        perm = z.MAE.permutation(SSL_PARITY_BATCH, 64, g, "cpu")
        model.permutation = lambda b, n, gen, device: perm.to(device)
        _loss_and_grads(model, with_gen, img)
    elif name == "MPP":
        model = _zoo_model(lambda: x.MPP(
            256, 32, 1024, 6, 8, 2048, channels=3, mask_prob=0.15,
            replace_prob=0.5, random_patch_prob=0.3), seed)
        draws = x.MPP.draws(SSL_PARITY_BATCH, 64, g, "cpu")
        model.draws = lambda b, n, gen, device: tuple(d.to(device)
                                                      for d in draws)
        _loss_and_grads(model, with_gen, img)
    else:
        student = _zoo_model(lambda: z.DinoHead(256, 65536, dim=1024), seed)
        teacher = _zoo_model(lambda: z.DinoHead(256, 65536, dim=1024),
                             seed + 1)
        feats = torch.randn(2, SSL_PARITY_BATCH, 1024, generator=g)

        def dino_step(m, v):
            with torch.no_grad():
                t = teacher.to(v.device)(v[1])
            return z.dino_loss(m(v[0]), t)

        _loss_and_grads(student, dino_step, feats)
        cpu_teacher = copy.deepcopy(teacher).cpu()
        z.ema_update(cpu_teacher, copy.deepcopy(student).cpu())
        z.ema_update(teacher, student)
        for (key, a), b in zip(teacher.named_parameters(),
                               cpu_teacher.parameters()):
            assert_close(a, b, 1e-6, floor=0.0, name=key)


@contextlib.contextmanager
def _draw_tape(aug, tape, replay):
    """``augment2d``'s two draw functions recording into ``tape``, or
    handing its tensors back in order (each of the shape asked for)."""
    saved = aug._uniform, aug._permutation
    if replay:
        it = iter(tape)

        def take(shape):
            value = next(it)
            assert value.shape == torch.Size(shape), (value.shape, shape)
            return value

        aug._uniform = lambda shape, gen, device: take(shape)
        aug._permutation = lambda rows, n, gen, device: take((rows, n))
    else:
        def recorded(fn):
            def draw(*args):
                tape.append(fn(*args))
                return tape[-1]
            return draw

        aug._uniform, aug._permutation = map(recorded, saved)
    try:
        yield
    finally:
        aug._uniform, aug._permutation = saved


# augment2d's ops on a batch: name -> op(aug, x, fixed arguments) for the
# fixed ones, op(aug, x, generator) for those that draw
AUG_FIXED = {
    "rgb_to_hsv": lambda aug, x, a: aug.rgb_to_hsv(x),
    "hsv_to_rgb": lambda aug, x, a: aug.hsv_to_rgb(x),
    "grayscale": lambda aug, x, a: aug.grayscale(x),
    "adjust_brightness": lambda aug, x, a: aug.adjust_brightness(x, a[0]),
    "adjust_contrast": lambda aug, x, a: aug.adjust_contrast(x, a[0]),
    "adjust_saturation": lambda aug, x, a: aug.adjust_saturation(x, a[0]),
    "adjust_hue": lambda aug, x, a: aug.adjust_hue(x, a[1]),
    "gaussian_blur": lambda aug, x, a: aug.gaussian_blur(x, a[2]),
    "normalize": lambda aug, x, a: aug.normalize(x),
    "crop_and_resize": lambda aug, x, a: aug.crop_and_resize(x, a[3],
                                                             (224, 224)),
}
AUG_DRAWN = {
    "color_jitter": lambda aug, x, gen: aug.color_jitter(x, gen),
    "random_grayscale": lambda aug, x, gen: aug.random_grayscale(x, gen),
    "random_hflip": lambda aug, x, gen: aug.random_hflip(x, gen),
    "random_gaussian_blur": lambda aug, x, gen: aug.random_gaussian_blur(
        x, gen, 0.5),
    "random_resized_crop": lambda aug, x, gen: aug.random_resized_crop(
        x, gen, 224, (0.08, 1.0)),
    "byol_augment": lambda aug, x, gen: aug.byol_augment(x, gen),
    "ssl_views_batch 224": lambda aug, x, gen: aug.ssl_views_batch(x, gen,
                                                                   224),
    "ssl_views_batch 96": lambda aug, x, gen: aug.ssl_views_batch(x, gen, 96),
}


@pytest.mark.parametrize("name", [*AUG_FIXED, *AUG_DRAWN])
def test_augment2d_matches_the_cpu(cuda, name):
    """An ``augment2d`` op on 32 images of 256x256x3, card against CPU
    within 1e-5 of the CPU's largest magnitude, with the CPU's draws
    replayed on the card under CUDA's sync debug mode set to raise (no
    host sync); ``ssl_views_batch`` drawing from a CUDA generator makes
    no host sync either."""
    from gfe_mamba_torch.data import augment2d as aug

    g = torch.Generator().manual_seed(195)
    imgs = torch.rand(32, 256, 256, 3, generator=g)
    args = (torch.linspace(0.2, 1.8, 32), torch.linspace(-0.5, 0.5, 32),
            torch.linspace(1.0, 2.0, 32),
            aug.sample_crop_box(g, (256, 256), (0.08, 1.0), batch=32))
    fixed = name in AUG_FIXED
    op = AUG_FIXED[name] if fixed else AUG_DRAWN[name]
    tape = []
    with _draw_tape(aug, tape, replay=False):
        want = op(aug, imgs, args if fixed else g)
    tape = [t.to(cuda) for t in tape]
    args_c, xc = tuple(a.to(cuda) for a in args), imgs.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _draw_tape(aug, tape, replay=True):
            got = op(aug, xc, args_c if fixed else None)
        if name == "ssl_views_batch 224":
            aug.ssl_views_batch(xc, torch.Generator(device=cuda)
                                .manual_seed(195), 224)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (a, w) in enumerate(zip(got, want)):
        assert_close(a, w, 1e-5, floor=0.0, name=str(i))


@pytest.mark.parametrize("name", list(SECOND_HALF))
def test_second_half_classifier_matches_the_cpu(cuda, name):
    """Eval mode, weights from a seed on the CPU: the logits (and the
    pooled features where the model has them) at batch 2 against the
    CPU; at batch 32 the outputs finite."""
    from gfe_mamba_torch.models import vit_zoo_final as f
    from gfe_mamba_torch.models import vit_zoo_hier as h

    make, shape = SECOND_HALF[name]
    seed = 210 + list(SECOND_HALF).index(name)
    model = _zoo_model(lambda: make(h, f), seed).eval()
    xs = torch.rand(PARITY_BATCH, *shape,
                    generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        want = ((model.features(xs), model(xs))
                if hasattr(model, "features") else model(xs))
    model.to(cuda)
    with torch.inference_mode():
        got = ((model.features(xs.to(cuda)), model(xs.to(cuda)))
               if hasattr(model, "features") else model(xs.to(cuda)))
    _close(got, want)
    xb = torch.rand(BATCH, *shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(seed))
    _finite(model, lambda m, v: m(v), (xb,))


def test_ats_vit_matches_the_cpu(cuda):
    """ATSViT (256/16, dim 1024, depth 6, tokens 256 .. 8, 16 heads) with
    the CPU's Gumbel uniforms handed to the card: the sampled ids exactly
    the CPU's, then the logits; with draws from a CUDA generator at batch
    32 the logits finite."""
    from gfe_mamba_torch.models import vit_zoo_final as f

    seed = 230
    model = _zoo_model(lambda: f.ATSViT(
        256, 16, 1000, 1024, 6, (256, 128, 64, 32, 16, 8), 16, 2048),
        seed).eval()
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device=cuda).manual_seed(seed)
    xs = torch.rand(PARITY_BATCH, 256, 256, 3, generator=g)
    layers = [m for m in model.modules() if isinstance(m, f._ATSAttention)]
    tape = {}

    def taped(i):
        def uniforms(shape, gen, device):
            if i not in tape:
                tape[i] = torch.rand(shape, generator=g)
            return tape[i].to(device)
        return uniforms

    for i, m in enumerate(layers):
        m.uniforms = taped(i)
    with torch.inference_mode():
        want, want_ids = model(xs, None, return_sampled_token_ids=True)
    model.to(cuda)
    with torch.inference_mode():
        got, ids = model(xs.to(cuda), None, return_sampled_token_ids=True)
    assert torch.equal(ids.cpu(), want_ids)
    assert_close(got, want, 1e-4, floor=0.0)
    for m in layers:
        del m.uniforms
    xb = torch.rand(BATCH, 256, 256, 3, device=cuda, generator=cuda_gen)
    _finite(model, lambda m, v: m(v, cuda_gen), (xb,))


def test_navit_matches_the_cpu(cuda):
    """NaViT (256/32, dim 1024, depth 6, 16 heads, token dropout 0.1) over
    the README's five images packed by the port's packer, card against
    CPU; over 32 images of sides drawn from {64, 128, 256}, grouped and
    packed at ``max_seq_len`` 256, the outputs finite."""
    import numpy as np

    from gfe_mamba_torch.models import vit_zoo_final as f

    seed = 231
    rng = np.random.default_rng(seed)
    readme = [[(256, 256), (128, 128)], [(128, 256), (256, 128)],
              [(64, 256)]]
    groups = [[rng.random((hh, ww, 3), dtype=np.float32) for hh, ww in grp]
              for grp in readme]
    sides = rng.choice((64, 128, 256), size=(32, 2))
    images = [rng.random((hh, ww, 3), dtype=np.float32) for hh, ww in sides]
    timed_groups = f.group_images_by_max_seq_len(images, 32,
                                                 lambda hh, ww: 0.1, 256)
    timed = f.pack_images(timed_groups, 32, 256, 0.1, seed=seed)
    packed = f.pack_images(groups, 32, 256, 0.1, seed=seed)
    most = max(len(grp) for grp in timed_groups + groups)
    model = _zoo_model(lambda: f.NaViT(256, 32, 1000, 1024, 6, 16, 2048,
                                       max_images=most), seed).eval()
    names = ("patches", "positions", "image_ids", "mask")
    inputs = tuple(torch.from_numpy(packed[k]) for k in names)
    with torch.inference_mode():
        want = model(*inputs)
    model.to(cuda)
    with torch.inference_mode():
        got = model(*(t.to(cuda) for t in inputs))
    _close(got, want)
    _finite(model, lambda m, *a: m(*a),
            tuple(torch.from_numpy(timed[k]).to(cuda) for k in names))


@pytest.mark.parametrize("name", ["SimMIM", "MP3", "DistillWrapper",
                                  "EsViT"])
def test_pretraining_loss_matches_the_cpu(cuda, name):
    """Loss and backward against the CPU at batch 2 with the draws
    shared: SimMIM (256/32, 1024, depth 6, 8 heads, masking 0.5), MP3
    (256/8, masking 0.75), DistillWrapper (student 256/32, T 3, alpha
    0.5; seeded teacher logits) and EsViTProjector (4 layers, hidden 256,
    out 65336) under both EsViT losses over 49 region tokens of width
    384, with ``esvit_center_update`` within 1e-6."""
    from gfe_mamba_torch.models import vit_zoo_final as f

    seed = 232 + ["SimMIM", "MP3", "DistillWrapper", "EsViT"].index(name)
    b = PARITY_BATCH
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device=cuda).manual_seed(seed)
    img = torch.rand(b, 256, 256, 3, generator=g)
    enc = dict(image_size=256, dim=1024, depth=6, heads=8, mlp_dim=2048)

    def with_gen(m, v):
        return m(v, cuda_gen if v.is_cuda else g)

    if name == "SimMIM":
        model = _zoo_model(lambda: f.SimMIM(patch_size=32, masking_ratio=0.5,
                                            **enc), seed)
        masked = f.SimMIM.masked_indices(
            b, model.pos_embedding.shape[1] - 1, model.num_masked, g, "cpu")
        model.masked_indices = lambda *a: masked.to(a[-1])
        _loss_and_grads(model, with_gen, img)
    elif name == "MP3":
        model = _zoo_model(lambda: f.MP3(f.MP3ViT(
            patch_size=8, num_classes=1000, **enc), 0.75), seed)
        order = f.MP3.permutation(b, model.mlp_head_dense.out_features, g,
                                  "cpu")
        model.permutation = lambda *a: order.to(a[-1])
        _loss_and_grads(model, with_gen, img)
    elif name == "DistillWrapper":
        model = _zoo_model(lambda: f.DistillWrapper(f.DistillableViT(
            patch_size=32, num_classes=1000, **enc), temperature=3.0,
            alpha=0.5), seed)
        teacher = torch.randn(b, 1000, generator=g)
        labels = torch.randint(0, 1000, (b,), generator=g)
        _loss_and_grads(model, lambda m, v: m(v, labels.to(v.device),
                                              teacher.to(v.device)), img)
    else:
        student = _zoo_model(lambda: f.EsViTProjector(65336, 4, 256, dim=384),
                             seed)
        teacher_head = _zoo_model(lambda: f.EsViTProjector(
            65336, 4, 256, dim=384), seed + 1)
        feats = torch.randn(2, b, 49, 384, generator=g)
        centers = torch.randn(2, 1, 65336, generator=g) * 0.1

        def esvit_step(m, v):
            c = centers.to(v.device)
            with torch.no_grad():
                head = teacher_head.to(v.device)
                t_view, t_regions = head(v[0].mean(dim=1)), head(v[0])
            view = f.esvit_view_loss(t_view, m(v[1].mean(dim=1)), c[0])
            region = f.esvit_region_loss(t_regions, m(v[1]), v[0], v[1],
                                         c[1])
            return view + region

        _loss_and_grads(student, esvit_step, feats)
        assert_close(f.esvit_center_update(centers[0].to(cuda),
                                           centers[1].to(cuda)),
                     f.esvit_center_update(centers[0], centers[1]), 1e-6,
                     floor=0.0)


def test_record_attention_matches_the_cpu(cuda):
    """``extract`` and ``record_attention`` on the ViT-B-like
    ClassifierViT (256/32, dim 1024, depth 6, 16 heads): the latent, the
    maps (2, 6, 16, 65, 65) and the logits against the CPU at batch 2,
    every map's rows summing to 1 within 1e-5, the logits with the
    recorder bitwise those without it."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_final as f

    model = _zoo_model(lambda: z.ClassifierViT(256, 32, 1000, 1024, 6, 16,
                                               2048), 233).eval()
    xs = torch.rand(PARITY_BATCH, 256, 256, 3,
                    generator=torch.Generator().manual_seed(233))
    with torch.inference_mode():
        want, want_latent = f.extract(model, xs)
        _, want_maps = f.record_attention(model, xs)
    model.to(cuda)
    with torch.inference_mode():
        got, latent = f.extract(model, xs.to(cuda))
        recorded, maps = f.record_attention(model, xs.to(cuda))
        plain = model(xs.to(cuda))
    assert maps.shape == (PARITY_BATCH, 6, 16, 65, 65)
    _close((got, latent, maps), (want, want_latent, want_maps))
    assert (maps.sum(dim=-1) - 1).abs().max().item() <= 1e-5
    assert torch.equal(recorded, plain) and torch.equal(got, plain)
