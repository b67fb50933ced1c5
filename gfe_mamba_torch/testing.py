"""What the port's tests and ``chip_smoke.py`` share: comparison helpers,
and the rank workers of the data-, tensor- and expert-parallel checks."""

from __future__ import annotations

import torch


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


# -- data-parallel runs of the trainers, one process per rank -----------
# Spawned through ``parallel/dryrun.py::launch`` by the tests and by
# ``chip_smoke.py``; the child processes import this module, never a test.

def tensor_digest(t: torch.Tensor) -> str:
    """A digest of a tensor's bytes: two ranks' tensors with equal digests
    are bitwise equal."""
    import hashlib
    t = t.detach().cpu().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()
                          if t.numel() else b"").hexdigest()


def _counters() -> dict:
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    return dict(K1=k1.launches, K2=k2.launches, K3=k1.dw_launches,
                K4=k2.bwd_launches)


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


def _time_allreduce(trainer, stage2: bool, mesh, device) -> dict:
    """The trainer's gradient average alone (``all_reduce_mean_`` over
    the data group, as its step calls it) on zero tensors of its
    trainable parameters' shapes: bytes and ms of each of 3 calls."""
    import time

    from gfe_mamba_torch.parallel.collectives import all_reduce_mean_

    params = list(trainer.trainable.values()) if stage2 else \
        [*trainer.g_params.values(), *trainer.d_params.values()]
    grads = [torch.zeros_like(p) for p in params]
    ms = []
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        all_reduce_mean_(grads, mesh.data_group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(bytes=sum(g.numel() * g.element_size() for g in grads),
                ms=ms)


def run_job(job: dict, mesh, device) -> dict:
    """Build the job's trainer (see :func:`dp_steps`), take its steps on
    this rank's rows of each global batch (every row without a mesh: the
    one-process reference), and report what the caller compares."""
    import time

    from gfe_mamba_torch.parallel.multihost import host_local, process_index
    from gfe_mamba_torch.utils.convert import jax_tree_from_state_dict

    stage2 = job["stage"] == 2
    trainer = (_stage2_trainer if stage2 else _stage1_trainer)(
        job, mesh, device)
    modules = {"model": trainer.model} if stage2 else {
        "generator": trainer.generator, "discriminator": trainer.discriminator}
    cuda = device.type == "cuda"
    out = {"logs": [], "step_ms": []}
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
            before = _counters()
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        logs = trainer.train_step(*args, *job.get("extra", ()))
        if cuda:
            torch.cuda.synchronize(device)
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["logs"].append(logs)
        if cuda and i == len(job["batches"]) - 1:
            after = _counters()
            out["launches"] = {k: after[k] - before[k] for k in after}
            out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if job.get("time_allreduce") and mesh is not None:
        out["allreduce"] = _time_allreduce(trainer, stage2, mesh, device)
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
    ``<out_dir>/rank<r>.pt``: per job the logs, step times, digests of
    every parameter, Adam's counts and (where ``keep``) the parameters
    and Adam's first moments (only on rank ``keep_rank`` when given), on
    the card also the launches and the peak memory of the last step, and
    with ``time_allreduce`` the gradient average timed alone; a Stage-2
    job also the dtypes its mixer's output took."""
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
