"""What the port's tests and ``chip_smoke.py`` share: comparison helpers,
the scan operands of a Mamba layer, the main paths built at the
benchmark's sizes with the kernels' launch counters, the checks and
witnesses of the card tests (``tests/*_cuda.py``), and the rank workers
of the data-, tensor- and expert-parallel checks."""

from __future__ import annotations

import contextlib

import torch

# the benchmark's scoring configuration (``portbench/configs/gfe_mamba``:
# batch 4, bf16) at its volume, which the card tests build
CANONICAL = dict(categories=(6,) * 8, num_continuous=40, dim=512, depth=6,
                 heads=8, seq_length=4, f_maps=(64, 128, 256))
CANONICAL_IMG = (160, 160, 96)
SCORE_BATCH = 4
# a stack of Jamba2-Mini's layout (8 layers: attention at 4, experts on
# the odd ones, 7 Mamba) at its Mamba widths (d_model 4096, ED 8192) with
# a small MLP, experts and vocabulary, and the shortest docqa prompt
JAMBA2_MINI_STACK = dict(d_model=4096, n_layers=8, mlp_size=512,
                         num_experts=4, num_experts_per_tok=2,
                         vocab_size=512, tie_lm_weights=False)
DOCQA_PROMPT = 4467
# the benchmark's segmentation model (``portbench/configs/unet3d_seg``:
# the JAX package's get_model defaults, pytorch3dunet's) and its patch
UNET3D = dict(name="UNet3D", in_channels=1, out_channels=1, f_maps=64,
              layer_order="gcr", num_groups=8)
UNET3D_PATCH = (64, 128, 128)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - bf16(want)| in bf16 ulps of bf16(want), ``want`` being
    an f32 result and ``got`` its bf16 counterpart.  An element below
    2^-8 of max |want| takes the ulp of that floor: there the rounding of
    f32 sums taken in different orders (~1e-7 of their terms) is what
    differs, not the one rounding to bf16."""
    want = want.detach().float().to(got.device)
    ref = want.bfloat16().float()
    floor = max(want.abs().max().item() * 2.0 ** -8, 1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=floor))) - 7)
    return ((got.detach().float() - ref).abs() / ulp).max().item()


def mamba_scan_operands(bsz: int, L: int, d_model: int, dtype, device,
                        d_state: int = 16, seed: int = 0,
                        input_dtype=None) -> list:
    """The scan's operands ``[x, delta, A, B, C, D, z, delta_bias]`` as one
    ``MambaBlock`` in ``dtype`` on ``device`` hands them over
    (``MambaBlock.scan_operands``): x channel-major, z, B and C views, A
    f32.  The block takes Mamba's init and the layer input is normal, all
    from ``seed``; the global RNG is left as it was.  ``input_dtype``
    (``dtype`` when omitted) is the layer input's: an f32 input to a
    bf16 block gives the bf16 Stage-2 step's operands, x, delta, z, B
    and C f32 views beside bf16 D and delta_bias."""
    from gfe_mamba_torch.models.mamba import MambaBlock, MambaConfig

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        block = MambaBlock(MambaConfig(d_model=d_model, n_layers=1,
                                       d_state=d_state))
    block.reset_ssm_parameters(gen)
    block = block.to(device, dtype)
    h = torch.randn(bsz, L, d_model, generator=gen).to(
        device, input_dtype or dtype)
    with torch.no_grad():
        return [t.detach() for t in block.scan_operands(h)]


# -- the main paths at the benchmark's sizes -----------------------------
# Built on the card by ``tests/test_torch_launches_cuda.py``, which
# asserts what one request or step of each launches, and by
# ``chip_smoke.py``, which reports those launches beside the kernel times.

def launch_counts() -> dict:
    """Every kernel's launch counter by the kernel table's ids, a variant
    after a dot: K1 and K3 on the tensor cores (``mma``) or not
    (``fma``), K2's long kernel."""
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import group_norm as k5
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    return {"K1": k1.launches, "K1.mma": k1.mma_launches,
            "K1.fma": k1.fma_launches, "K2": k2.launches,
            "K2.long": k2.long_launches, "K3": k1.dw_launches,
            "K3.mma": k1.dw_mma_launches, "K3.fma": k1.dw_fma_launches,
            "K4": k2.bwd_launches, "K5a": k5.stats_launches,
            "K5b": k5.apply_launches}


def launches_since(before: dict, device=None) -> dict:
    """The launches of each counter of :func:`launch_counts` since
    ``before`` was read, ``device`` synchronized first."""
    torch.cuda.synchronize(device)
    return {k: n - before[k] for k, n in launch_counts().items()}


def scoring_model(device, mixer: str = "mamba"):
    """The benchmark's scoring model in bf16 (weights from seed 0) with
    the ``mixer`` head."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    return build_gfe_mamba(img_size=CANONICAL_IMG, device=device,
                           dtype=torch.bfloat16, seed=0, mixer=mixer,
                           **CANONICAL)


def scoring_request(model, gen: torch.Generator, batch: int = SCORE_BATCH):
    """One request of ``batch`` volumes and tables drawn from ``gen`` on
    its device: ``(logits, pet)`` under inference mode."""
    dev = gen.device
    mri = torch.randn(batch, *CANONICAL_IMG, 1, generator=gen, device=dev)
    x_cat = torch.randint(0, 6, (batch, 8), generator=gen, device=dev)
    x_num = torch.randn(batch, 40, generator=gen, device=dev)
    with torch.inference_mode():
        return model(mri.bfloat16(), x_cat, x_num.bfloat16(),
                     return_pet=True)


def stage2_trainer(device, mixer: str = "mamba"):
    """``ClassifyTrainer`` over the canonical model in f32 (seed 0) with
    the ``mixer`` head, its defaults (bf16, dropout on)."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
    model = build_gfe_mamba(img_size=CANONICAL_IMG, device=device, seed=0,
                            mixer=mixer, **CANONICAL)
    return ClassifyTrainer(model, device=device)


def stage2_step(trainer, gen: torch.Generator) -> dict:
    """One Stage-2 step at batch 1 on inputs drawn from ``gen``."""
    dev = gen.device
    return trainer.train_step(
        torch.randn(1, *CANONICAL_IMG, 1, generator=gen, device=dev),
        torch.randint(0, 6, (1, 8), generator=gen, device=dev),
        torch.randn(1, 40, generator=gen, device=dev),
        torch.randint(0, 2, (1,), generator=gen, device=dev).float())


def stage1_trainer(device):
    """``GanTrainer`` over the canonical generator (seed 0),
    ``PatchDiscriminator(3, 32)`` and ``PerceptualLoss(0.25)``, its
    defaults (bf16)."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    disc = PatchDiscriminator(3, 32)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    return GanTrainer(build_generator(device=device, seed=0), disc,
                      PerceptualLoss(0.25, device=device), device=device)


def stage1_step(trainer, gen: torch.Generator) -> dict:
    """One Stage-1 step at batch 1, ``adv_on=1``, on an MRI and a PET
    drawn from ``gen``."""
    mri, pet = (torch.randn(1, *CANONICAL_IMG, 1, generator=gen,
                            device=gen.device) for _ in range(2))
    return trainer.train_step(mri, pet, 1.0)


def jamba2_mini_stack(device):
    """A ``JambaLM`` of ``JAMBA2_MINI_STACK`` in bf16, weights from seed 9
    under the torch law, in eval mode."""
    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM
    cfg = JambaConfig(**JAMBA2_MINI_STACK)
    return materialized(lambda: JambaLM(cfg), seed=9).to(
        device, torch.bfloat16).eval()


def docqa_prompt(device, length: int = DOCQA_PROMPT):
    """A prompt of ``length`` tokens of the stack's vocabulary (seed 10)."""
    return torch.randint(0, JAMBA2_MINI_STACK["vocab_size"], (1, length),
                         generator=torch.Generator().manual_seed(10)).to(
                             device)


# -- the card tests' checks and witness ----------------------------------

def assert_close(got, want, rel: float, floor: float = 1.0,
                 name: str = "") -> None:
    """max |got - want| within ``rel`` of max(``floor``, max |want|), both
    read in f32 on the host; at ``floor`` 0 a zero ``want`` asks for an
    exact zero."""
    got = torch.as_tensor(got).detach().float().cpu()
    want = torch.as_tensor(want).detach().float().cpu()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = max(floor, want.abs().max().item() if want.numel() else 0.0)
    assert err <= rel * scale, (name, err, scale)


def assert_logs_close(want: dict, got: dict, rel: float) -> None:
    """Each logged loss of ``want`` within ``rel`` of max(1, |want|)."""
    for key, value in want.items():
        assert abs(got[key] - value) <= rel * max(1.0, abs(value)), \
            (key, got[key], value)


def materialized(make, seed: int):
    """``make()`` built on the meta device and filled on the CPU from
    ``seed`` under the torch law, as ``build_gfe_mamba`` fills a model."""
    from gfe_mamba_torch.utils.initializers import init_weights

    with torch.device("meta"):
        module = make()
    module.to_empty(device="cpu")
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


def moment_errors(pairs, floor: float = 1e-6) -> dict:
    """Per tensor, the distance between the Adam first moments (0.1 x the
    clipped gradient after one step) of two runs, ``{name: (max-rel,
    norm-rel)}`` over ``pairs`` of ``(player, opt_a, params_a, opt_b,
    params_b)``: max |d| over the tensor's largest entry, and |d| over its
    norm.  A tensor under ``floor`` per entry (1e-5 of a clipped gradient
    of norm <= 1) is measured against the floor: such a gradient is zero
    in exact arithmetic (an attention's key bias, which the softmax
    cancels) and holds rounding noise only."""
    out = {}
    for player, opt_a, params_a, opt_b, params_b in pairs:
        for (name, pa), pb in zip(params_a.items(), params_b.values()):
            if pa not in opt_a.state:
                continue
            got = opt_b.state[pb]["exp_avg"].detach().float()
            want = opt_a.state[pa]["exp_avg"].detach().to(got.device).float()
            diff = got - want
            out[f"{player}:{name}"] = (
                diff.abs().max().item() / max(floor, want.abs().max().item()),
                diff.norm().item() / max(want.norm().item(),
                                         floor * want.numel() ** 0.5))
    return out


def worst_errors(errors: dict) -> tuple[float, float]:
    """The worst max-rel and norm-rel of :func:`moment_errors`."""
    return (max(e[0] for e in errors.values()),
            max(e[1] for e in errors.values()))


@contextlib.contextmanager
def plain_convs_on_card():
    """The conv Function with K1 and K3 swapped for their plain versions
    on CUDA tensors: a witness run that separates what the kernels do
    from what two f32 forwards on two devices do."""
    from gfe_mamba_torch.ops import conv3d as ops_conv
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    saved = ops_conv.conv3x3x3_cuda, ops_conv.conv3x3x3_dw_cuda
    ops_conv.conv3x3x3_cuda = kc.conv3x3x3_plain
    ops_conv.conv3x3x3_dw_cuda = kc.conv3x3x3_dw_plain
    try:
        yield
    finally:
        ops_conv.conv3x3x3_cuda, ops_conv.conv3x3x3_dw_cuda = saved


def yaml_text(cf: dict) -> str:
    """A flat config as YAML the port's reader takes: strings quoted,
    sequences as flow lists."""
    def scalar(v):
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, bool):
            return "true" if v else "false"
        if v is None:
            return "null"
        return repr(v)
    return "".join(
        f"{k}: [{', '.join(scalar(x) for x in v)}]\n"
        if isinstance(v, (list, tuple)) else f"{k}: {scalar(v)}\n"
        for k, v in cf.items())


# -- data-parallel runs of the trainers, one process per rank -----------
# Spawned through ``parallel/dryrun.py::launch`` by the tests; the child
# processes import this module, never a test.

def tensor_digest(t: torch.Tensor) -> str:
    """A digest of a tensor's bytes: two ranks' tensors with equal digests
    are bitwise equal."""
    import hashlib
    t = t.detach().cpu().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()
                          if t.numel() else b"").hexdigest()


def _stage2_trainer(job: dict, mesh, device):
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
    from gfe_mamba_torch.utils.convert import load_jax_tree

    model = build_gfe_mamba(device="cpu", **job["build"])
    if job.get("jax") is not None:
        load_jax_tree(model, job["jax"])
    _split(job, model, mesh)
    return ClassifyTrainer(model, device=device, mesh=mesh,
                           **job["trainer"])


def _stage1_trainer(job: dict, mesh, device):
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer
    from gfe_mamba_torch.utils.convert import load_jax_tree

    gen = build_generator(device="cpu", **job["build"])
    disc = PatchDiscriminator(*job["disc"])
    disc.reset_parameters(torch.Generator().manual_seed(1))
    perceptual = PerceptualLoss(job["fake_3d_ratio"], device=device)
    if job.get("jax") is not None:
        load_jax_tree(gen, job["jax"]["g"])
        load_jax_tree(disc, job["jax"]["d"])
    _split(job, gen, mesh)
    return GanTrainer(gen, disc, perceptual, device=device, mesh=mesh,
                      **job["trainer"])


def _split(job: dict, model, mesh) -> None:
    from gfe_mamba_torch.parallel.sharding import (apply_param_shardings,
                                                   infer_param_shardings)
    if job.get("threshold") is not None and mesh is not None \
            and mesh.model_size > 1:
        apply_param_shardings(model, infer_param_shardings(
            model, mesh.model_size, threshold=job["threshold"],
            layer_order=job["build"].get("layer_order", "gcr")),
            mesh.model_group)


def _adam_moments(opt, params: dict) -> dict:
    return {n: opt.state[p]["exp_avg"] for n, p in params.items()
            if p in opt.state and "exp_avg" in opt.state[p]}


def run_job(job: dict, mesh, device) -> dict:
    """Build the job's trainer (see :func:`dp_steps`), take its steps on
    this rank's rows of each global batch (every row without a mesh: the
    one-process reference), and report what the caller compares."""
    from gfe_mamba_torch.parallel.multihost import host_local, process_index
    from gfe_mamba_torch.utils.convert import jax_tree_from_state_dict

    stage2 = job["stage"] == 2
    trainer = (_stage2_trainer if stage2 else _stage1_trainer)(
        job, mesh, device)
    modules = {"model": trainer.model} if stage2 else {
        "generator": trainer.generator, "discriminator": trainer.discriminator}
    cuda = device.type == "cuda"
    out = {"logs": []}
    if stage2:
        seen = set()
        trainer.model.classifier.transformer.register_forward_hook(
            lambda m, i, o: seen.add(
                str((o[0] if isinstance(o, tuple) else o).dtype)))
        out["mixer_dtypes"] = seen
    for i, batch in enumerate(job["batches"]):
        rows = slice(None) if mesh is None else \
            mesh.local_rows(len(next(iter(batch.values()))))
        args = [torch.from_numpy(batch[k][rows]) for k in job["keys"]]
        if cuda:
            torch.cuda.synchronize(device)
            before = launch_counts()
        logs = trainer.train_step(*args, *job.get("extra", ()))
        out["logs"].append(logs)
        if cuda and i == len(job["batches"]) - 1:
            out["launches"] = launches_since(before, device)
    params = {name: host_local(m) for name, m in modules.items()}
    if stage2:
        opts = {"model": (trainer.optimizer, trainer.trainable)}
    else:
        opts = {"generator": (trainer.g_opt, trainer.g_params),
                "discriminator": (trainer.d_opt, trainer.d_params)}
    moments = {name: _adam_moments(*pair) for name, pair in opts.items()}
    counts = {name: sorted({int(s["step"]) for s in opt.state.values()})
              for name, (opt, _) in opts.items()}
    out["digests"] = {f"{name}.{k}": tensor_digest(v)
                      for name, state in params.items()
                      for k, v in state.items()}
    out["adam_counts"] = counts
    if job.get("keep", True) and job.get("keep_rank", process_index()) \
            == process_index():
        order = job["build"].get("layer_order", "gcr")
        if job.get("jax_keys"):
            out["params"] = {name: jax_tree_from_state_dict(state, order)
                             for name, state in params.items()}
        else:
            out["params"] = params
        out["moments"] = {name: {k: v.detach().cpu().clone()
                                 for k, v in m.items()}
                          for name, m in moments.items()}
    return out


def dp_steps(out_dir: str, spec: dict) -> None:
    """One rank of a data-parallel run (inside ``parallel/dryrun.py::
    launch``): for each job of ``spec["jobs"]``, a Stage-2 or Stage-1
    trainer on the mesh ``spec.get("mesh")`` (default: every rank on
    ``data``), its weights from the job's ``build`` seed or its ``jax``
    tree, split over the model axis at ``threshold`` when given, steps on
    this rank's rows of each of the job's global ``batches``; writes
    ``<out_dir>/rank<r>.pt``: per job the logs, digests of every
    parameter, Adam's counts and (where ``keep``) the parameters and
    Adam's first moments (only on rank ``keep_rank`` when given), on the
    card also the launches of the last step; a Stage-2 job also the
    dtypes its mixer's output took."""
    import os

    from gfe_mamba_torch.parallel import multihost
    from gfe_mamba_torch.parallel.mesh import make_mesh

    mesh = make_mesh(spec.get("mesh"))
    device = torch.device(spec["device"])
    result = {job["name"]: run_job(job, mesh, device)
              for job in spec["jobs"]}
    result["mesh"] = dict(shape=mesh.shape, data_index=mesh.data_index,
                          model_index=mesh.model_index)
    torch.save(result, os.path.join(
        out_dir, f"rank{multihost.process_index()}.pt"))


def tp_forward_and_grads(out_dir: str, spec: dict) -> None:
    """One rank of the tensor- and expert-parallel check (inside
    ``launch``): the pipeline of ``spec["build"]`` with the flax tree
    ``spec["jax"]`` loaded and its parameters split over a model axis of
    every rank at ``spec["threshold"]``; the eval-mode logits of
    ``spec["inputs"]`` and the gradients of their mean BCE against
    ``spec["labels"]`` for every parameter outside the frozen generator
    (whose forward runs without a gradient), the shards all-gathered.
    Rank 0 writes ``<out_dir>/tp.pt``: the logits, the gradients as a
    flax tree, and the split model's weights gathered back into one
    (``utils/convert.py::jax_tree_from_module``)."""
    import os

    import torch.nn.functional as F

    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.parallel import multihost
    from gfe_mamba_torch.parallel.collectives import all_gather_cat
    from gfe_mamba_torch.parallel.mesh import make_mesh
    from gfe_mamba_torch.parallel.sharding import (apply_param_shardings,
                                                   infer_param_shardings,
                                                   sharded_state)
    from gfe_mamba_torch.utils.convert import (jax_tree_from_module,
                                               jax_tree_from_state_dict,
                                               load_jax_tree)

    mesh = make_mesh({"data": 1, "model": multihost.process_count()})
    model = build_gfe_mamba(device="cpu", **spec["build"])
    order = spec["build"].get("layer_order", "gcr")
    shardings = infer_param_shardings(model, mesh.model_size,
                                      threshold=spec["threshold"],
                                      layer_order=order)
    apply_param_shardings(model, shardings, mesh.model_group)
    load_jax_tree(model, spec["jax"])
    model.eval()
    inputs = [torch.from_numpy(a) for a in spec["inputs"]]
    logits = model(*inputs).float().squeeze(-1)
    loss = F.binary_cross_entropy_with_logits(
        logits, torch.from_numpy(spec["labels"]))
    params = {n: p for n, p in model.named_parameters()
              if not n.startswith("generator.")}       # frozen, no_grad
    names = list(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    splits = sharded_state(model)
    whole = {n: all_gather_cat(g, *splits[n]) if n in splits else g
             for n, g in zip(names, grads)}
    weights = jax_tree_from_module(model, order)
    if multihost.is_main_process():
        torch.save(dict(logits=logits.detach(), loss=float(loss),
                        split=sorted(splits), weights=weights,
                        grads=jax_tree_from_state_dict(whole, order)),
                   os.path.join(out_dir, "tp.pt"))
