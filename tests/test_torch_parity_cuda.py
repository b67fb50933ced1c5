"""The port on the card against the port on the CPU, from the same
weights: the full-width pipeline, one training step of each trainer, the
bf16 Stage-2 step, skipped steps, the other Stage-2 heads and the
recurrent step.  Every test needs an NVIDIA GPU (``cuda`` marker) and
skips without one; the file imports torch and the port only::

    python -m pytest --noconftest -m cuda tests/test_torch_parity_cuda.py -q

Everything runs at the canonical widths (dim 512, depth 6, f_maps
64/128/256) on a (64, 64, 32) volume, f32 with TF32 off unless a test
says otherwise.  An f32 pre-activation within rounding of 0 takes
opposite relu masks on the two devices and moves a few gradients by
~1e-2, whatever computes the convs, so a relu step is held to twice the
distance of a witness: the same step on the card with the plain convs in
place of K1 and K3.
"""

import copy
import math

import pytest
import torch

from gfe_mamba_torch.testing import (CANONICAL, assert_close,
                                     assert_logs_close, materialized,
                                     moment_errors, plain_convs_on_card,
                                     worst_errors)

pytestmark = pytest.mark.cuda

IMG = (64, 64, 32)
REDUCED = dict(img_size=IMG, vit_patch_size=16, vit_dropout=0.0,
               vit_emb_dropout=0.0)
# the biases of the layers that compute in bf16 on both devices in the
# bf16 Stage-2 step (sums over rows of a bf16 cotangent; the key bias's
# is zero in exact arithmetic)
STAGE2_BF16_BIASES = ("combiner.vit_mid_linear.bias",
                      "classifier.final_cross.k_proj.bias",
                      "classifier.final_cross.v_proj.bias")
# CrossJambaBoth at depth 6 has 12 layers, layer 4 attention: 11 Mamba
JAMBA_SCANS = 11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stage2_batch(seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(2, *IMG, 1, generator=gen),
            torch.randint(0, 6, (2, 8), generator=gen),
            torch.randn(2, 40, generator=gen), torch.tensor([1.0, 0.0]))


def test_pipeline_matches_the_cpu(cuda):
    """Logits and PET of the full-width pipeline, the CPU's plain
    versions against the card's kernels, within 1e-3."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba

    cpu = build_gfe_mamba(img_size=IMG, vit_patch_size=16, device="cpu",
                          seed=1, **CANONICAL)
    card = copy.deepcopy(cpu).to(cuda)
    mri, x_cat, x_num, _ = _stage2_batch(11)
    with torch.inference_mode():
        want = cpu(mri, x_cat, x_num, return_pet=True)
        got = card(mri.to(cuda), x_cat.to(cuda), x_num.to(cuda),
                   return_pet=True)
    for name, a, b in zip(("logits", "pet"), got, want):
        assert torch.isfinite(a).all(), name
        assert_close(a, b, 1e-3, name=name)


def test_stage2_step_matches_the_cpu(cuda):
    """One f32 Stage-2 step, dropout off: the losses within 1e-3, every
    trainable gradient (Adam's first moment) within 1e-3 of its largest
    entry and of its norm."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    cpu = build_gfe_mamba(device="cpu", seed=1, cross_ff_dropout=0.0,
                          **REDUCED, **CANONICAL)
    card = copy.deepcopy(cpu)
    batch = _stage2_batch(21)
    trainers = [ClassifyTrainer(m, mixed_precision="none", device=d)
                for m, d in ((cpu, "cpu"), (card, cuda))]
    logs = [tr.train_step(*batch) for tr in trainers]
    torch.cuda.synchronize()
    assert_logs_close(logs[0], logs[1], 1e-3)
    errors = moment_errors([("C", trainers[0].optimizer,
                             dict(trainers[0].trainable),
                             trainers[1].optimizer,
                             dict(trainers[1].trainable))])
    assert errors and max(worst_errors(errors)) <= 1e-3, errors


@pytest.mark.parametrize("order,adv_on,seed", [("gcr", 1.0, 2),
                                               ("gcr", 1.0, 12),
                                               ("gce", 0.0, 2)])
def test_stage1_step_matches_the_cpu(cuda, order, adv_on, seed):
    """One f32 Stage-1 step.  The canonical order gcr with the adversary
    on: relu in G and leaky relu in D flip a few masks between the
    devices, so the kernels' gradients must come within twice the
    witness's worst error, by either measure (and within 1e-3 where the
    witness is closer than 5e-4), the losses within 1e-3.  The order gce
    (elu) with the adversary off removes D from G's loss: no mask flips,
    so G's gradients through K1, K1-as-dz and K3 agree within 1e-3."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    generator = build_generator(device="cpu", seed=seed, layer_order=order,
                                **REDUCED)
    disc = PatchDiscriminator(3, 32)
    disc.reset_parameters(torch.Generator().manual_seed(seed + 1))
    perceptual = PerceptualLoss(0.25, device="cpu")
    witness = adv_on > 0
    models = [(generator, disc, perceptual)] + [
        tuple(copy.deepcopy(m) for m in (generator, disc, perceptual))
        for _ in range(2 if witness else 1)]
    gen = torch.Generator().manual_seed(21 + seed)
    mri, pet = (torch.randn(1, *IMG, 1, generator=gen) for _ in range(2))
    trainers = [GanTrainer(*m, mixed_precision="none", device=d)
                for m, d in zip(models, ("cpu", cuda, cuda))]
    logs = [tr.train_step(mri, pet, adv_on) for tr in trainers[:2]]
    if witness:
        with plain_convs_on_card():
            logs.append(trainers[2].train_step(mri, pet, adv_on))
    torch.cuda.synchronize()

    def pairs(a, b):
        out = [("G", a.g_opt, a.g_params, b.g_opt, b.g_params)]
        if adv_on:
            out.append(("D", a.d_opt, a.d_params, b.d_opt, b.d_params))
        return out

    assert_logs_close(logs[0], logs[1], 1e-3)
    errors = moment_errors(pairs(trainers[0], trainers[1]))
    assert errors
    tol = (1e-3, 1e-3)
    if witness:
        assert_logs_close(logs[0], logs[2], 1e-3)
        plain = worst_errors(moment_errors(pairs(trainers[0], trainers[2])))
        tol = tuple(max(1e-3, 2 * p) for p in plain)
    got = worst_errors(errors)
    assert got[0] <= tol[0] and got[1] <= tol[1], (got, tol)


@pytest.mark.parametrize("mixer", ["mamba", "jamba"])
def test_stage2_bf16_step_matches_the_cpu(cuda, mixer):
    """The bf16 Stage-2 step on the card against the CPU's bf16 step from
    the same weights and batch, dropout off; the CPU's f32 step gives the
    scale.  The card's step is handed the CPU generator's bf16 outputs by
    a forward hook (the two devices round the generator's bf16 convs
    differently, as far apart as bf16 from f32).  The loss, the logits
    and each trainable gradient (the norm of the difference) lie within
    half their distance between the CPU's bf16 and f32 steps, or of 2^-8
    of their norm where that distance cancels below bf16's resolution;
    ``STAGE2_BF16_BIASES`` within the whole distance.  The mixer's output
    is f32 on both devices, as JAX's."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    batch = _stage2_batch(31)
    base = build_gfe_mamba(device="cpu", seed=3, mixer=mixer,
                           attn_dropout=0.0, ff_dropout=0.0,
                           cross_ff_dropout=0.0, **REDUCED, **CANONICAL)
    runs, handed = {}, {}
    for tag, mp, device in (("cpu f32", "none", "cpu"),
                            ("cpu bf16", "bf16", "cpu"),
                            ("card bf16", "bf16", cuda)):
        model = copy.deepcopy(base)
        trainer = ClassifyTrainer(model, mixed_precision=mp, device=device)
        if tag == "cpu bf16":
            model.generator.register_forward_hook(
                lambda m, i, o: handed.setdefault("outputs", o))
        elif tag == "card bf16":
            outputs = tuple(t.to(cuda) for t in handed["outputs"])
            model.generator.register_forward_hook(lambda m, i, o: outputs)
        dtypes = set()
        model.classifier.transformer.register_forward_hook(
            lambda m, i, o: dtypes.add(
                (o[0] if isinstance(o, tuple) else o).dtype))
        model.train()
        with torch.no_grad():
            logits = trainer._logits(*trainer._inputs(*batch[:3]))
        grads, logs = trainer.gradients(*batch)
        runs[tag] = dict(loss=logs["cla_loss"], logits=logits.cpu(),
                         grads=dict(zip(trainer.trainable,
                                        (g.float().cpu() for g in grads))),
                         dtypes=dtypes)
        del trainer, model
    f32, cpu, dev = runs["cpu f32"], runs["cpu bf16"], runs["card bf16"]
    assert cpu["dtypes"] == dev["dtypes"] == {torch.float32}

    def ratio(got, want, other):
        got, want, other = (torch.as_tensor(t, dtype=torch.float64)
                            for t in (got, want, other))
        scale = max(float((want - other).norm()),
                    2.0 ** -8 * float(want.norm()), 1e-30)
        return float((got - want).norm()) / scale

    ratios = {"loss": ratio(dev["loss"], cpu["loss"], f32["loss"]),
              "logits": ratio(dev["logits"], cpu["logits"], f32["logits"])}
    for name, g in dev["grads"].items():
        ratios[name] = ratio(g, cpu["grads"][name], f32["grads"][name])
    bad = {n: r for n, r in ratios.items()
           if not r <= (1.0 if n in STAGE2_BF16_BIASES else 0.5)}
    assert not bad, bad


def test_skipped_stage2_step(cuda):
    """A Stage-2 step with a NaN in x_num moves no parameter and no
    moment but counts; the finite step after it is Adam's update at count
    2, (m / (1 - b1^2)) / (sqrt(v / (1 - b2^2)) + eps), as in the JAX
    trainer."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    model = build_gfe_mamba(device=cuda, seed=3, cross_ff_dropout=0.0,
                            **REDUCED, **CANONICAL)
    trainer = ClassifyTrainer(model, mixed_precision="none", device=cuda)
    mri, x_cat, x_num, labels = (t.to(cuda) for t in _stage2_batch(31))
    params = list(trainer.trainable.values())
    before = [p.detach().clone() for p in params]
    bad = x_num.clone()
    bad[0, 0] = float("nan")
    assert trainer.train_step(mri, x_cat, bad, labels)["skipped"] == 1.0
    state = [trainer.optimizer.state[p] for p in params]
    assert all(s["step"].item() == 1 and not s["exp_avg"].any()
               and not s["exp_avg_sq"].any() for s in state)
    assert all(torch.equal(p, b) for p, b in zip(params, before))
    logs = trainer.train_step(mri, x_cat, x_num, labels)
    group = trainer.optimizer.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    worst = 0.0
    for p, p0, s in zip(params, before, state):
        want = p0 - lr * (s["exp_avg"] / (1 - b1 ** 2)) / (
            (s["exp_avg_sq"] / (1 - b2 ** 2)).sqrt() + eps)
        tol = 1e-3 * lr + 2.5e-7 * p0.abs().clamp(min=1.0)
        worst = max(worst, ((p.detach() - want).abs() / tol).max().item())
    assert not logs["skipped"]
    assert {s["step"].item() for s in state} == {2}
    assert worst <= 1.0, worst


@pytest.mark.parametrize("fresh", [False, True])
def test_skipped_stage1_step(cuda, fresh):
    """``GanTrainer`` (adversary on, ``d_fresh_recon`` off and on): a
    finite step, one with a NaN in the PET, a finite one.  The NaN step
    moves no parameter and no Adam moment of G or D (bit for bit) and
    advances both players' Adam counts, as optax's count advances under
    the JAX trainer's finite guard; the next step is finite and counts."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    gen = torch.Generator(device=cuda).manual_seed(32)
    mri, pet = (torch.randn(1, *IMG, 1, generator=gen, device=cuda)
                for _ in range(2))
    bad = pet.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    disc = PatchDiscriminator(3, 32)
    disc.reset_parameters(torch.Generator().manual_seed(5))
    trainer = GanTrainer(build_generator(device=cuda, seed=4, **REDUCED),
                         disc, PerceptualLoss(0.25, device=cuda),
                         mixed_precision="none", d_fresh_recon=fresh,
                         device=cuda)
    players = ((trainer.g_opt, trainer.g_params),
               (trainer.d_opt, trainer.d_params))

    def snapshot():
        return [t.clone() for opt, params in players
                for p in params.values()
                for t in (p.detach(), opt.state[p]["exp_avg"],
                          opt.state[p]["exp_avg_sq"])]

    def counts():
        return [{opt.state[p]["step"].item() for p in params.values()}
                for opt, params in players]

    logs = [trainer.train_step(mri, pet, 1.0)]
    before = snapshot()
    logs.append(trainer.train_step(mri, bad, 1.0))
    after = snapshot()
    skipped_counts = counts()
    logs.append(trainer.train_step(mri, pet, 1.0))
    torch.cuda.synchronize()
    assert [lg["skipped"] for lg in logs] == [0.0, 1.0, 0.0]
    assert skipped_counts == [{2}, {2}] and counts() == [{3}, {3}]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(math.isfinite(v) for v in logs[2].values())


def _head_inputs():
    """Classifier inputs of the canonical table (53 tokens) over the slice
    tokens of two volumes of ``IMG``."""
    gen = torch.Generator().manual_seed(13)
    cats, dim = CANONICAL["categories"], CANONICAL["dim"]
    return (torch.randint(0, 6, (2, len(cats)), generator=gen),
            torch.randn(2, CANONICAL["num_continuous"], generator=gen),
            torch.randn(2, CANONICAL["seq_length"], dim, generator=gen),
            [torch.randn(2, *IMG, 1, generator=gen) for _ in range(2)])


def _head(mixer):
    from gfe_mamba_torch.models.ft_transformer import CrossTransformerBoth
    from gfe_mamba_torch.models.fusion import CrossJambaBoth

    cats, dim, heads = (CANONICAL["categories"], CANONICAL["dim"],
                        CANONICAL["heads"])
    common = dict(dim=dim, depth=CANONICAL["depth"], heads=heads,
                  d_cross=IMG[0] * IMG[1])
    if mixer == "jamba":
        return materialized(lambda: CrossJambaBoth(
            cats, CANONICAL["num_continuous"], **common), seed=3).eval()
    return materialized(lambda: CrossTransformerBoth(
        cats, CANONICAL["num_continuous"], dim_head=dim // heads, **common),
        seed=3).eval()


@pytest.mark.parametrize("mixer,scans", [("jamba", JAMBA_SCANS),
                                         ("transformer", 0)])
def test_other_heads_match_the_cpu(cuda, mixer, scans):
    """``CrossJambaBoth`` (16 experts top-2) and ``CrossTransformerBoth``
    at the canonical width, f32: card against CPU within 1e-3; K2 once
    per Mamba layer of Jamba's, never for the transformer."""
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    cpu = _head(mixer)
    card = copy.deepcopy(cpu).to(cuda)
    inputs = _head_inputs()
    with torch.inference_mode():
        want = cpu(*inputs)
        k2.launches = 0
        got = card(*(t.to(cuda) for t in inputs[:3]),
                   [v.to(cuda) for v in inputs[3]])
        torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert_close(got, want, 1e-3)
    assert k2.launches == scans


def test_recurrent_steps_match_the_forward(cuda):
    """The canonical Jamba stack and a 6-layer Mamba of width 512, stepped
    token by token over the head's 53 tokens on the card in f32, equal
    their forward within 1e-4; ``generate(top_k=1)`` of a ``JambaLM`` of
    that width is the greedy argmax of its forward."""
    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM, generate
    from gfe_mamba_torch.models.mamba import Mamba, MambaConfig

    dim, depth = CANONICAL["dim"], CANONICAL["depth"]
    head = _head("jamba").to(cuda)
    x_cat, x_num, feature, _ = _head_inputs()
    with torch.inference_mode():
        seq = torch.cat([head.embed(x_cat.to(cuda), x_num.to(cuda)),
                         feature.to(cuda)], dim=1)
    mamba = materialized(lambda: Mamba(MambaConfig(d_model=dim,
                                                   n_layers=depth)),
                         seed=4).to(cuda)
    stacks = ((head.transformer, lambda x: head.transformer(x)[0],
               lambda t: t[:, None], lambda y: y[:, 0],
               {"max_len": seq.shape[1]}),
              (mamba, mamba, lambda t: t, lambda y: y, {}))
    for stack, forward, token, out, cache_kw in stacks:
        with torch.inference_mode():
            full = forward(seq)
            caches, steps = stack.init_cache(seq.shape[0], **cache_kw), []
            for i in range(seq.shape[1]):
                y, caches = stack.step(token(seq[:, i]), caches)
                steps.append(out(y))
        assert_close(torch.stack(steps, dim=1), full, 1e-4)
    cfg = JambaConfig(d_model=dim, n_layers=2 * depth, mlp_size=2 * dim,
                      num_attention_heads=CANONICAL["heads"], vocab_size=64)
    lm = materialized(lambda: JambaLM(cfg), seed=5).to(cuda)
    prompt = torch.randint(0, 64, (2, 8),
                           generator=torch.Generator().manual_seed(6))
    tokens = generate(lm, prompt.to(cuda), 8,
                      torch.Generator(device=cuda).manual_seed(7), top_k=1)
    with torch.inference_mode():
        greedy = lm(tokens)[0][:, prompt.shape[1] - 1:-1].argmax(-1)
    assert torch.equal(greedy, tokens[:, prompt.shape[1]:])
