"""The multi-process dry run (the port's twin of
``__graft_entry__.dryrun_multichip`` and ``_dryrun_gan``):

    python -m gfe_mamba_torch.parallel.dryrun --procs N [--device cpu]

N processes (one per card by default, ``--device cpu`` for all on the
CPU, or ``--device cuda:0 --backend gloo`` for N ranks on one card) lay
out a (data, model) grid: ``model`` 2 when N >= 4 and N is even (or
``--model``), else 1; the rest ``data``.  On JAX's tiny Jamba pipeline
(``_canonical_pipeline(small=True)``) and its generator, dropout off
(each rank draws its own masks, so a replay could not draw the same
ones), with the sharding threshold at 128:

(a) Stage 2: the tensor- (TP) and expert-parallel (EP) split model, each
    rank on its rows of the global batch (DP): the gradient and one
    ``ClassifyTrainer`` step equal a single-process replay of the whole
    batch from the same weights (gradient within 5e-5, loss 1e-5 + 1e-4
    relative, parameters within 4 lr: Adam's first step moves an entry
    by about lr * sign(g), and a gradient within rounding of 0 may take
    either sign), and a second sharded step re-enters;
(b) Stage 1: the generator split the same way, ``GanTrainer``'s G
    gradient under DP x TP equals the replay's within 5e-5, then one
    fused G + D step with the warm-up gate off and on: g_loss and both
    players' updated parameters equal the replay's (1e-5 + 1e-4
    relative; 4e-3, JAX's bound for lr_d 5e-4).

:func:`launch` starts ranks for the dry run and for the tests: each
process gets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as a launcher
sets them and meets the others through a ``file://`` rendezvous; a rank
that fails or outlives the timeout ends all of them.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gfe_mamba_torch import resolve_device

LR = 1e-4


def _entry(rank: int, world: int, init_file: str, device: str,
           backend, timeout_s: float, fn, args) -> None:
    from gfe_mamba_torch.parallel import multihost
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    multihost.initialize(device, backend=backend, timeout_s=timeout_s,
                         init_method=f"file://{init_file}")
    try:
        fn(*args)
    finally:
        multihost.shutdown()


def launch(fn, nprocs: int, args: tuple = (), *, device: str = "cpu",
           backend=None, timeout_s: float = 300.0,
           pg_timeout_s: float = 60.0) -> None:
    """Run ``fn(*args)`` on ``nprocs`` fresh processes joined in one
    process group (``multihost.initialize`` with ``device`` and
    ``backend``; ``pg_timeout_s`` for its collectives).  Raises if a rank
    fails, or kills them all after ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gfe_rdzv_") as tmp:
        ctx = mp.start_processes(
            _entry, args=(nprocs, os.path.join(tmp, "rendezvous"), device,
                          backend, pg_timeout_s, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks still running "
                                       f"after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


# -- the dry run --------------------------------------------------------

TINY_PIPELINE = dict(
    categories=(3, 5, 2), num_continuous=4, dim=32, depth=1, heads=2,
    seq_length=2, f_maps=(4, 8, 16), layer_order="cge", fold_factor=2,
    vit_patch_size=4, vit_dim=16, vit_depth=1, vit_heads=2, vit_mlp_dim=32,
    mixer="jamba", attn_dropout=0.0, ff_dropout=0.0, cross_ff_dropout=0.0)
TINY_GENERATOR = dict(f_maps=(4, 8, 16), layer_order="cge", fold_factor=2,
                      vit_patch_size=4, vit_dim=16, vit_depth=1,
                      vit_heads=2, vit_mlp_dim=32, vit_dropout=0.0,
                      vit_emb_dropout=0.0)
IMG = (16, 16, 8)
THRESHOLD = 128


def _require(ok: bool, message: str) -> None:
    """A check of the dry run (raised also under ``python -O``)."""
    if not ok:
        raise AssertionError(message)


def model_axis(procs: int) -> int:
    """JAX's split: a model axis of 2 when there are at least 4 ranks and
    an even number of them, else 1."""
    return 2 if procs % 2 == 0 and procs >= 4 else 1


def _max_err(got: dict, want: dict, shardings: dict, mesh) -> float:
    """max |got - want| over the entries of ``got`` (this rank's shards)
    and the matching slices of ``want`` (whole tensors)."""
    err = 0.0
    for name, g in got.items():
        w = want[name]
        if name in shardings:
            dim = shardings[name].dim
            per = g.shape[dim]
            w = w.narrow(dim, mesh.model_index * per, per)
        err = max(err, float((g.detach().float() - w.detach().float())
                             .abs().max()))
    return err


def _split(model, mesh):
    from gfe_mamba_torch.parallel.sharding import (apply_param_shardings,
                                                   infer_param_shardings)
    shardings = infer_param_shardings(model, mesh.model_size,
                                      threshold=THRESHOLD, layer_order="cge")
    apply_param_shardings(model, shardings, mesh.model_group)
    return shardings


def _stage2(mesh, device, f_maps) -> str:
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    batch = mesh.data_size * 2
    rs = np.random.RandomState(0)
    mri = torch.from_numpy(rs.randn(batch, *IMG, 1).astype(np.float32))
    x_cat = torch.zeros(batch, 3, dtype=torch.int32)
    x_num = torch.ones(batch, 4)
    labels = torch.from_numpy((np.arange(batch) % 2).astype(np.float32))
    rows = mesh.local_rows(batch)

    def trainer(split: bool):
        model = build_gfe_mamba(img_size=IMG, seed=0, device="cpu",
                                **widths(TINY_PIPELINE, f_maps))
        shardings = _split(model, mesh) if split else {}
        return ClassifyTrainer(model, lr=LR, mixed_precision="none",
                               device=device,
                               mesh=mesh if split else None), shardings

    sharded, shardings = trainer(True)
    replay, _ = trainer(False)
    local = [t[rows] for t in (mri, x_cat, x_num, labels)]
    g_mesh, _ = sharded.gradients(*local)
    g_one, _ = replay.gradients(mri, x_cat, x_num, labels)
    g_err = _max_err(dict(zip(sharded.trainable, g_mesh)),
                     dict(zip(replay.trainable, g_one)), shardings, mesh)
    _require(g_err < 5e-5, f"gradient divergence: max abs err {g_err}")

    logs = sharded.train_step(*local)
    ref = replay.train_step(mri, x_cat, x_num, labels)
    loss, ref_loss = logs["cla_loss"], ref["cla_loss"]
    _require(np.isfinite(loss) and np.isfinite(ref_loss)
             and abs(loss - ref_loss) < 1e-5 + 1e-4 * abs(ref_loss),
             f"sharded loss {loss} != single-process {ref_loss}")
    p_err = _max_err(dict(sharded.model.named_parameters()),
                     dict(replay.model.named_parameters()), shardings, mesh)
    _require(p_err < 4 * LR, f"param-update divergence: max abs err {p_err}")
    logs = sharded.train_step(*local)
    _require(np.isfinite(logs["cla_loss"]) and not logs["skipped"],
             f"the second sharded step: {logs}")
    return (f"stage 2: loss={loss:.4f} replay={ref_loss:.4f} "
            f"grad_max_abs_err={g_err:.2e} "
            f"param_update_max_abs_err={p_err:.2e}; {len(shardings)} "
            f"parameters split")


def _stage1(mesh, device, f_maps) -> str:
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    batch = mesh.data_size * 2
    rs = np.random.RandomState(1)
    mri = torch.from_numpy(rs.randn(batch, *IMG, 1).astype(np.float32))
    pet = torch.from_numpy(rs.randn(batch, *IMG, 1).astype(np.float32))
    rows = mesh.local_rows(batch)

    def trainer(split: bool):
        gen = build_generator(img_size=IMG, seed=0, device="cpu",
                              **widths(TINY_GENERATOR, f_maps))
        shardings = _split(gen, mesh) if split else {}
        disc = PatchDiscriminator(2, 4)
        disc.reset_parameters(torch.Generator().manual_seed(1))
        return GanTrainer(gen, disc, PerceptualLoss(0.5, device=device),
                          mixed_precision="none", device=device,
                          mesh=mesh if split else None), shardings

    sharded, shardings = trainer(True)
    replay, _ = trainer(False)
    g_mesh = sharded.gradients(mri[rows], pet[rows], 1.0)[0]
    g_one = replay.gradients(mri, pet, 1.0)[0]
    g_err = _max_err(dict(zip(sharded.g_params, g_mesh)),
                     dict(zip(replay.g_params, g_one)), shardings, mesh)
    _require(g_err < 5e-5,
             f"GAN generator gradient divergence: max abs err {g_err}")

    for adv_on in (0.0, 1.0):
        sharded, _ = trainer(True)
        replay, _ = trainer(False)
        logs = sharded.train_step(mri[rows], pet[rows], adv_on)
        ref = replay.train_step(mri, pet, adv_on)
        loss, ref_loss = logs["g_loss"], ref["g_loss"]
        _require(np.isfinite(loss) and np.isfinite(ref_loss)
                 and abs(loss - ref_loss) < 1e-5 + 1e-4 * abs(ref_loss),
                 f"GAN loss (adv_on={adv_on}): sharded {loss}, "
                 f"single-process {ref_loss}")
        p_err = max(
            _max_err(dict(sharded.generator.named_parameters()),
                     dict(replay.generator.named_parameters()), shardings,
                     mesh),
            _max_err(dict(sharded.discriminator.named_parameters()),
                     dict(replay.discriminator.named_parameters()), {},
                     mesh))
        _require(p_err < 4e-3, f"GAN param-update divergence (adv_on="
                               f"{adv_on}): max abs err {p_err}")
    return (f"stage 1: g_loss={loss:.4f} replay={ref_loss:.4f} "
            f"grad_max_abs_err={g_err:.2e} "
            f"param_update_max_abs_err={p_err:.2e}; warm-up gate off and "
            f"on; {len(shardings)} generator parameters split")


def widths(kwargs: dict, f_maps) -> dict:
    """``kwargs`` at the generator widths ``f_maps`` (the classifier's
    dim follows: the combiner's tokens are 2 * f_maps[-1] wide)."""
    out = dict(kwargs, f_maps=tuple(f_maps))
    if "dim" in out:
        out["dim"] = 2 * f_maps[-1]
    return out


def run(model: int, device, f_maps=(4, 8, 16)) -> None:
    """One rank of the dry run (inside :func:`launch`)."""
    from gfe_mamba_torch.parallel import multihost
    from gfe_mamba_torch.parallel.mesh import make_mesh

    # f32 means f32 on the card too: the replay and the split step must
    # not differ by TF32 rounding of the discriminator's convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = multihost.initialize(device)    # joined: this rank's device
    n = multihost.process_count()
    mesh = make_mesh({"data": n // model, "model": model})
    lines = [_stage2(mesh, device, f_maps), _stage1(mesh, device, f_maps)]
    if multihost.is_main_process():
        for line in lines:
            print(f"dryrun({n}) mesh={mesh.shape} {line} ok", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--procs", type=int, default=4)
    parser.add_argument("--model", type=int, default=None,
                        help="size of the model axis (default: 2 when "
                             "--procs is even and >= 4, else 1)")
    parser.add_argument("--device", default=None,
                        help="default: one card per rank (cuda:LOCAL_RANK; "
                             "raises without a card); 'cuda:0' puts every "
                             "rank on card 0; 'cpu' runs on the CPU")
    parser.add_argument("--backend", default=None,
                        help="default: nccl on CUDA, gloo on the CPU")
    parser.add_argument("--f_maps", default="4,8,16",
                        help="generator widths (JAX's tiny pipeline's by "
                             "default; the card's conv kernel takes "
                             "multiples of 8, e.g. 8,16,32)")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    model = args.model or model_axis(args.procs)
    if args.procs % model:
        raise ValueError(f"--model {model} does not divide --procs "
                         f"{args.procs}")
    resolve_device(args.device)          # no card and no --device: raise
    t = time.perf_counter()
    f_maps = tuple(int(f) for f in args.f_maps.split(","))
    launch(run, args.procs, (model, args.device, f_maps), device=args.device,
           backend=args.backend, timeout_s=args.timeout)
    print(f"dryrun({args.procs}): ok in {time.perf_counter() - t:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
