#!/usr/bin/env python
"""Quality of the PyTorch port over whole training runs: both stages
trained end to end on a synthetic cohort, then scored with the
reference's metric set (P/R/F1/Acc/MCC), beside the JAX package's
artifact of the same experiment.

    python3 quality_torch.py --geometry small       # -> QUALITY_torch.json
    python3 quality_torch.py --geometry canonical   # -> CANONICAL_torch.json
    python3 quality_torch.py --geometry small --smoke --device cpu

``--geometry small`` is the port's side of ``tools/quality_parity.py``
under ``--gan --hard`` (its ``run_jax`` and ``main``, step for step):
32x32x16, f_maps 8/16/32, classifier dim 64, depth 2, heads 4, seq 4,
ViT 64/2/2/128, batch 8, Adam 1e-4 and clip 1.0; Stage 1 is the full
GAN game (``PatchDiscriminator(3, 32)``, ``PerceptualLoss(0.25)``,
LSGAN weight 0.01, perceptual 0.001, D at 5e-4, warm-up 5 epochs, D
trained on a fresh reconstruction), all in f32 with TF32 off (JAX's
``--matmul-precision highest``); Stage 2 trains the classifier on the
frozen generator.  20 + 60 epochs over seeds 0-5, 128 training and 512
test subjects, as ``QUALITY_r04.json``.  The cohort
(``make_cohort``), the batch order (``_epoch_batches``) and the metrics
come from ``tools/quality_parity.py`` by import (numpy only), so both
packages see the same subjects in the same order.

``--geometry canonical`` is the port's side of
``tools/canonical_convergence.py --hard`` at ``CANONICAL_r04.json``'s
configuration: 160x160x96, f_maps 64/128/256, dim 512, depth 6, heads 8,
bf16, batch 1 (Stage 1) and 2 (Stage 2), 256 training, 64 validation
(every 2 epochs; the first best validation MCC keeps its weights) and 192
test subjects, 10 + 20 epochs, warm-up 3.  The tabular columns come from
that script's ``tabular`` by import; the volumes are synthesised on the
device per subject index when batched (:func:`synth_volumes` from the
draws of :func:`subject_draws`), the law of its ``make_synth``: the
same index always gives the same volume, and no cohort is held on the
host.

The initial weights and the canonical cohort's noise are drawn from
``torch.Generator``s, not ``jax.random`` keys, so the comparison is in
law: the artifact holds the port's pooled metrics, JAX's (read from the
TPU artifact named in ``reference``), their difference and the per-seed
spread.  No quality bound is asserted.

``--smoke``: a few subjects and one epoch per stage at the geometry's
widths (the adversary on from the first epoch); ``--tiny`` shrinks the
canonical geometry to the small one's shape and widths, as
``canonical_convergence.py --smoke`` does, for a run on the CPU.
``--device``: the card unless ``cpu`` is asked for.  For the canonical
geometry, ``--stage1-npz`` splits a run at the stage boundary (the
generator saved after Stage 1, or loaded and Stage 1 skipped, its batch
draws replayed so that Stage 2 sees the same order) and
``--mixed-precision none`` runs both stages in f32.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from gfe_mamba_torch import resolve_device  # noqa: E402
from gfe_mamba_torch.losses.perceptual import PerceptualLoss  # noqa: E402
from gfe_mamba_torch.models.discriminator import \
    PatchDiscriminator  # noqa: E402
from gfe_mamba_torch.models.pipeline import (build_gfe_mamba,  # noqa: E402
                                             build_generator)
from gfe_mamba_torch.training.classify_trainer import \
    ClassifyTrainer  # noqa: E402
from gfe_mamba_torch.training.checkpoint import (  # noqa: E402
    load_params_npz, save_params_npz)
from gfe_mamba_torch.training.gan_trainer import GanTrainer  # noqa: E402
from tools import quality_parity as qp  # noqa: E402  (numpy only)
from tools.canonical_convergence import tabular  # noqa: E402

SMALL_GEN = dict(f_maps=(8, 16, 32), fold_factor=8, vit_patch_size=4,
                 vit_dim=64, vit_depth=2, vit_heads=2, vit_mlp_dim=128)
SMALL_CLS = dict(dim=64, depth=2, heads=4, seq_length=4)
CANONICAL_GEN = dict(f_maps=(64, 128, 256))
CANONICAL_CLS = dict(dim=512, depth=6, heads=8, seq_length=4)
REFERENCE = {"small": "QUALITY_r04.json", "canonical": "CANONICAL_r04.json"}


# ---------------------------------------------------------------------------
# the canonical cohort's volumes (tools/canonical_convergence.py::make_synth)

def _knobs(hard: bool):
    """(bright-blob contrast, ventricle radius delta, noise sd, P(opposite
    imaging phenotype))."""
    return (0.10, 0.5, 0.35, 0.15) if hard else (0.40, 2.0, 0.16, 0.0)


def synth_volumes(noise: torch.Tensor, flip: torch.Tensor,
                  labels: torch.Tensor, hard: bool = True):
    """``make_synth``'s subjects from their draws: ``noise`` (B, X, Y, Z)
    standard normal, ``flip`` (B,) 1 where the subject expresses the
    opposite phenotype, ``labels`` (B,); f32 on ``noise``'s device.
    Returns ``(mri, pet)``, each (B, X, Y, Z, 1)."""
    img_gap, vent_gap, noise_sd, _ = _knobs(hard)
    shape = noise.shape[1:]
    dev, f32 = noise.device, torch.float32
    sx, sy, sz = shape[0] / 32.0, shape[1] / 32.0, shape[2] / 16.0
    xs = torch.arange(shape[0], dtype=f32, device=dev)[:, None, None]
    ys = torch.arange(shape[1], dtype=f32, device=dev)[None, :, None]
    zs = torch.arange(shape[2], dtype=f32, device=dev)[None, None, :]

    def blob(cx, cy, cz, r):
        return torch.exp(-(((xs - cx * sx) ** 2 + (ys - cy * sy) ** 2
                            + (zs - cz * sz) ** 2) / (2.0 * (r * sx) ** 2)))

    flip = flip.to(dev, f32)[:, None, None, None]
    label = labels.to(dev, f32)[:, None, None, None]
    phen = flip * (1.0 - label) + (1.0 - flip) * label
    bright = 0.95 - img_gap * phen
    vent = 2.5 + vent_gap * phen
    vol = (0.30 * blob(10.0, 16.0, 8.0, 6.0)
           + bright * blob(22.0, 16.0, 8.0, 5.0)
           - 0.8 * blob(16.0, 10.0, 8.0, vent)
           + noise_sd * noise)
    mri = torch.clamp(vol, -1.0, 1.0)
    pet = mri
    for ax in (1, 2, 3):
        pet = (torch.roll(pet, 1, ax) + 2 * pet + torch.roll(pet, -1, ax)) / 4
    pet = torch.clamp(1.0 - pet, -1.0, 1.0)
    return mri[..., None], pet[..., None]


def subject_draws(seed: int, idxs, shape, device, hard: bool = True):
    """Each subject's draws from a ``torch.Generator`` on ``device`` seeded
    by (``seed``, subject index): ``(noise (B, X, Y, Z), flip (B,))``."""
    express_p = _knobs(hard)[3]
    noise, flip = [], []
    for idx in idxs:
        g = torch.Generator(device=device).manual_seed(
            (7000 + seed) * 2 ** 24 + int(idx))
        noise.append(torch.randn(tuple(shape), generator=g, device=device))
        u = torch.rand((), generator=g, device=device)
        flip.append((u < express_p).float())
    return torch.stack(noise), torch.stack(flip)


# ---------------------------------------------------------------------------
# shared pieces

def _stage1_trainer(seed, device, shape, gen_kwargs, mixed, fresh):
    generator = build_generator(seed=seed, device=device, img_size=shape,
                                **gen_kwargs)
    disc = PatchDiscriminator(num_layers_d=3, num_channels=32)
    disc.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return GanTrainer(generator, disc,
                      PerceptualLoss(fake_3d_ratio=0.25, seed=0,
                                     device=device),
                      lr_g=1e-4, lr_d=5e-4, adv_weight=qp.ADV_WEIGHT,
                      perceptual_weight=qp.PERC_WEIGHT,
                      mixed_precision=mixed, d_fresh_recon=fresh,
                      device=device, seed=seed)


def _stage2_trainer(seed, device, shape, gen_kwargs, cls_kwargs, mixed,
                    generator):
    model = build_gfe_mamba(categories=(2, 3), num_continuous=4,
                            img_size=shape, seed=seed, device=device,
                            **cls_kwargs, **gen_kwargs)
    model.generator.load_state_dict(generator.state_dict())
    return ClassifyTrainer(model, lr=1e-4, mixed_precision=mixed,
                           device=device, seed=seed)


def _spread(values) -> dict:
    values = np.asarray(values, np.float64)
    sd = float(values.std(ddof=1)) if values.size > 1 else 0.0
    return {"mean": float(values.mean()), "sd": sd,
            "sem": sd / math.sqrt(values.size), "min": float(values.min()),
            "max": float(values.max())}


def _reference(geometry: str):
    path = os.path.join(REPO, REFERENCE[geometry])
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# small geometry: tools/quality_parity.py::run_jax under --gan --hard

def run_small_seed(cohort, seed: int, epochs1: int, epochs2: int,
                   warm: int, device, batch: int = 8,
                   verbose: bool = False) -> dict:
    rng_np = np.random.default_rng(1000 + seed)
    tr, te = cohort["train"], cohort["test"]

    def vol(a):
        return torch.from_numpy(np.ascontiguousarray(a[..., None])).to(device)

    mri_tr, pet_tr = vol(tr["mri"]), vol(tr["pet"])
    t0 = time.perf_counter()
    trainer1 = _stage1_trainer(seed, device, qp.SHAPE, SMALL_GEN, "none",
                               True)
    step_ms = []
    for epoch in range(epochs1):
        adv_on = 1.0 if epoch + 1 > warm else 0.0
        losses = []
        for idx in qp._epoch_batches(rng_np, len(tr["mri"]), batch):
            i = torch.from_numpy(idx).to(device)
            t = time.perf_counter()
            logs = trainer1.train_step(mri_tr[i], pet_tr[i], adv_on)
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(logs["l1"])
        if verbose:
            print(f"[torch] seed {seed} stage1 epoch {epoch + 1}: "
                  f"l1={np.mean(losses):.4f} adv_on={adv_on}", flush=True)
    rec = np.concatenate([
        trainer1.generate(vol(te["mri"][i:i + batch]))[..., 0].cpu().numpy()
        for i in range(0, len(te["mri"]), batch)])
    s1 = qp.recon_metrics(rec, te["pet"])
    t1 = time.perf_counter()

    trainer2 = _stage2_trainer(seed, device, qp.SHAPE, SMALL_GEN, SMALL_CLS,
                               "none", trainer1.generator)
    del trainer1
    x_cat, x_num = (torch.from_numpy(tr["x_cat"]).to(device),
                    torch.from_numpy(tr["x_num"]).to(device))
    y = torch.from_numpy(tr["y"].astype(np.float32)).to(device)
    step2_ms = []
    for epoch in range(epochs2):
        losses = []
        for idx in qp._epoch_batches(rng_np, len(tr["mri"]), batch):
            i = torch.from_numpy(idx).to(device)
            t = time.perf_counter()
            logs = trainer2.train_step(mri_tr[i], x_cat[i], x_num[i], y[i])
            step2_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(logs["cla_loss"])
        if verbose:
            print(f"[torch] seed {seed} stage2 epoch {epoch + 1}: "
                  f"bce={np.mean(losses):.4f}", flush=True)
    preds = []
    for i in range(0, len(te["mri"]), batch):
        sl = slice(i, i + batch)
        probs, _, _ = trainer2.eval_step(
            vol(te["mri"][sl]), torch.from_numpy(te["x_cat"][sl]),
            torch.from_numpy(te["x_num"][sl]),
            torch.from_numpy(te["y"][sl].astype(np.float32)))
        preds.append(probs.cpu().numpy() >= 0.5)
    t2 = time.perf_counter()
    return {"seed": seed,
            "gfe_mamba_torch": {**qp.metrics_from_preds(
                np.concatenate(preds), te["y"]), **s1},
            "stage1_seconds": t1 - t0, "stage2_seconds": t2 - t1,
            "stage1_step_ms": float(np.median(step_ms)) if step_ms else None,
            "stage2_step_ms": float(np.median(step2_ms)) if step2_ms
            else None}


def run_small(args, device) -> dict:
    seeds = [0] if args.smoke else args.seeds
    epochs1, epochs2 = (1, 1) if args.smoke else (args.epochs1,
                                                  args.epochs2)
    warm = 0 if args.smoke else qp.WARM_EPOCHS
    n_train, n_test = (16, 16) if args.smoke else (128, args.n_test)
    qp.HARD = True
    runs = []
    for seed in seeds:
        cohort = qp.make_cohort(seed, n_train=n_train, n_test=n_test)
        runs.append(run_small_seed(cohort, seed, epochs1, epochs2, warm,
                                   device, verbose=args.verbose))
        print(json.dumps(runs[-1]), flush=True)

    pooled = {k: float(np.mean([r["gfe_mamba_torch"][k] for r in runs]))
              for k in runs[0]["gfe_mamba_torch"]}
    report = {
        "config": {"geometry": "small", "shape": list(qp.SHAPE),
                   "f_maps": list(SMALL_GEN["f_maps"]),
                   **SMALL_CLS,
                   "vit": {k[4:]: v for k, v in SMALL_GEN.items()
                           if k.startswith("vit_")},
                   "batch": 8, "epochs1": epochs1, "epochs2": epochs2,
                   "seeds": seeds, "n_train": n_train, "n_test": n_test,
                   "gan": True, "hard": True, "warm_epochs": warm,
                   "d_fresh_recon": True, "mixed_precision": "none",
                   "tf32": False, "smoke": bool(args.smoke),
                   **_device_fields(device)},
        "gfe_mamba_torch": pooled,
        "per_seed_spread": {k: _spread([r["gfe_mamba_torch"][k]
                                        for r in runs])
                            for k in ("f1", "mcc")},
        "seconds": {"stage1": sum(r["stage1_seconds"] for r in runs),
                    "stage2": sum(r["stage2_seconds"] for r in runs)},
        "runs": runs,
    }
    ref = _reference("small")
    if ref is not None:
        jax_runs = {r["seed"]: r["gfe_mamba_tpu"] for r in ref["runs"]}
        report["reference"] = {
            "artifact": REFERENCE["small"], "package": "gfe_mamba_tpu",
            "platform": ref["config"].get("platform"),
            "gfe_mamba_tpu": ref["gfe_mamba_tpu"],
            "per_seed_spread": {k: _spread([r[k] for r in jax_runs.values()])
                                for k in ("f1", "mcc")}}
        report["comparison"] = _compare(report, jax_runs, runs)
    return report


def _compare(report, jax_runs, runs) -> dict:
    """The port's pooled metrics minus JAX's, in points, beside the
    standard error of that difference (both packages' per-seed spreads)
    and the per-seed differences on the seeds both ran."""
    out = {}
    for k in ("f1", "mcc", "stage1_l1", "stage1_psnr"):
        ours = report["gfe_mamba_torch"][k]
        theirs = report["reference"]["gfe_mamba_tpu"][k]
        out[f"delta_{k}"] = ours - theirs
    for k in ("f1", "mcc"):
        se = math.hypot(report["per_seed_spread"][k]["sem"],
                        report["reference"]["per_seed_spread"][k]["sem"])
        delta = out[f"delta_{k}"]
        out[f"delta_{k}_pt"] = 100 * delta
        out[f"se_delta_{k}_pt"] = 100 * se
        out[f"{k}_below_by_more_than_two_se"] = bool(delta < -2 * se)
        out[f"per_seed_delta_{k}_pt"] = {
            r["seed"]: 100 * (r["gfe_mamba_torch"][k] - jax_runs[r["seed"]][k])
            for r in runs if r["seed"] in jax_runs}
    return out


# ---------------------------------------------------------------------------
# canonical geometry: tools/canonical_convergence.py --hard

def run_canonical(args, device) -> dict:
    seed, hard = args.seed, True
    shape = qp.SHAPE if args.tiny else (160, 160, 96)
    gen_kwargs = SMALL_GEN if args.tiny else CANONICAL_GEN
    cls_kwargs = SMALL_CLS if args.tiny else CANONICAL_CLS
    b1, b2 = 1, 2
    n_train, n_val, n_test = ((4, 2, 2) if args.smoke else
                              (args.n_train, args.n_val, args.n_test))
    val_every = 1 if args.smoke else args.val_every
    epochs1, epochs2 = (1, 1) if args.smoke else (args.epochs1_canonical,
                                                  args.epochs2_canonical)
    warm = 0 if args.smoke else args.warm_epochs
    n = n_train + n_val + n_test
    labels, x_cat, x_num = tabular(seed, n, hard=hard)
    lab, cat, num = (torch.from_numpy(labels), torch.from_numpy(x_cat),
                     torch.from_numpy(x_num))
    rng_np = np.random.default_rng(1000 + seed)

    def synth(idx):
        noise, flip = subject_draws(seed, idx, shape, device, hard)
        return synth_volumes(noise, flip, lab[idx], hard)

    def batches(n_items, batch):
        order = rng_np.permutation(n_items)
        for i in range(0, n_items - batch + 1, batch):
            yield order[i:i + batch]

    report = {"config": {"geometry": "canonical", "shape": list(shape),
                         "f_maps": list(gen_kwargs["f_maps"]),
                         **cls_kwargs, "n_train": n_train, "n_val": n_val,
                         "val_every": val_every, "n_test": n_test,
                         "epochs1": epochs1, "epochs2": epochs2,
                         "warm_epochs": warm, "batch1": b1, "batch2": b2,
                         "mixed_precision": args.mixed_precision,
                         "seed": seed,
                         "hard": hard, "smoke": bool(args.smoke),
                         "tiny": bool(args.tiny), **_device_fields(device)},
              "stage1_l1": [], "stage2_bce": []}

    mixed = args.mixed_precision
    if args.stage1_npz and os.path.exists(args.stage1_npz):
        generator = build_generator(seed=seed, device=device, img_size=shape,
                                    **gen_kwargs)
        load_params_npz(args.stage1_npz, generator)
        for _ in range(epochs1):            # Stage 1's batch orders
            rng_np.permutation(n_train)
        report["stage1_from"] = args.stage1_npz
    else:
        trainer1 = _stage1_trainer(seed, device, shape, gen_kwargs, mixed,
                                   False)
        t0, step_ms = time.perf_counter(), []
        for epoch in range(epochs1):
            adv_on = 1.0 if epoch + 1 > warm else 0.0
            losses = []
            for idx in batches(n_train, b1):
                mri, pet = synth(idx)
                t = time.perf_counter()
                logs = trainer1.train_step(mri, pet, adv_on)
                step_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(logs["l1"])
            report["stage1_l1"].append(float(np.mean(losses)))
            print(f"stage1 epoch {epoch + 1}/{epochs1}: "
                  f"l1={np.mean(losses):.4f} adv_on={adv_on} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        report["stage1_seconds"] = time.perf_counter() - t0
        report["stage1_step_ms"] = float(np.median(step_ms))
        generator = trainer1.generator
        del trainer1
        if args.stage1_npz:
            save_params_npz(args.stage1_npz, generator)

    trainer2 = _stage2_trainer(seed, device, shape, gen_kwargs, cls_kwargs,
                               mixed, generator)
    del generator
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def eval_range(start, count):
        """Predictions over subjects [start, start + count), batches of
        b2 (a trailing part batch is dropped)."""
        if count < b2:
            raise ValueError(f"eval_range needs at least one batch: "
                             f"count={count} < batch2={b2}")
        preds = []
        for i in range(start, start + count - b2 + 1, b2):
            idx = np.arange(i, i + b2)
            mri, _ = synth(idx)
            probs, _, _ = trainer2.eval_step(mri, cat[idx], num[idx],
                                             lab[idx])
            preds.append(probs.cpu().numpy() >= 0.5)
        preds = np.concatenate(preds)
        return preds, labels[start:start + len(preds)]

    trainable = trainer2.trainable
    best = {"mcc": -2.0, "epoch": -1, "params": None}
    report["val_mcc"] = []
    t0, step_ms = time.perf_counter(), []
    for epoch in range(epochs2):
        losses = []
        for idx in batches(n_train, b2):
            mri, _ = synth(idx)
            t = time.perf_counter()
            logs = trainer2.train_step(mri, cat[idx], num[idx], lab[idx])
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(logs["cla_loss"])
        report["stage2_bce"].append(float(np.mean(losses)))
        msg = f"stage2 epoch {epoch + 1}/{epochs2}: bce={np.mean(losses):.4f}"
        if n_val and ((epoch + 1) % val_every == 0 or epoch + 1 == epochs2):
            vp, vl = eval_range(n_train, n_val)
            vmcc = qp.metrics_from_preds(vp, vl)["mcc"]
            report["val_mcc"].append([epoch + 1, vmcc])
            msg += f" val_mcc={vmcc:+.3f}"
            if vmcc > best["mcc"]:          # the first best on ties
                best = {"mcc": vmcc, "epoch": epoch + 1,
                        "params": {k: p.detach().clone()
                                   for k, p in trainable.items()}}
        print(f"{msg} ({time.perf_counter() - t0:.0f}s)", flush=True)
    report["stage2_seconds"] = time.perf_counter() - t0
    report["stage2_step_ms"] = float(np.median(step_ms))

    t0 = time.perf_counter()
    test_at = n_train + n_val
    preds, lab_eval = eval_range(test_at, n_test)
    report["final_metrics"] = qp.metrics_from_preds(preds, lab_eval)
    report["schema"] = 2
    report["metrics"] = dict(report["final_metrics"])
    if best["params"] is not None:
        with torch.no_grad():
            for k, p in trainable.items():
                p.copy_(best["params"][k])
        preds, lab_eval = eval_range(test_at, n_test)
        report["best_val_epoch"] = best["epoch"]
        report["best_ckpt_metrics"] = qp.metrics_from_preds(preds, lab_eval)
    report["eval_seconds"] = time.perf_counter() - t0
    report["note"] = (
        "the port's side of tools/canonical_convergence.py --hard: "
        "metrics/final_metrics = last-epoch test metrics, "
        "best_ckpt_metrics = test metrics of the first best-validation "
        "checkpoint; volumes drawn per subject from torch.Generators, so "
        "the cohort agrees with JAX's in law only")
    ref = _reference("canonical")
    if ref is not None:
        # CANONICAL_r04.json predates schema 2: its "metrics" are the
        # best-validation checkpoint's
        ref_best = ref.get("best_ckpt_metrics", ref["metrics"]) \
            if ref.get("schema") == 2 else ref["metrics"]
        report["reference"] = {
            "artifact": REFERENCE["canonical"], "package": "gfe_mamba_tpu",
            "platform": ref["config"].get("platform"),
            "best_ckpt_metrics": ref_best,
            "final_metrics": ref["final_metrics"],
            "best_val_epoch": ref.get("best_val_epoch"),
            "stage1_seconds": ref.get("stage1_seconds"),
            "stage2_seconds": ref.get("stage2_seconds")}
        report["comparison"] = {
            f"delta_{which}_{k}": report[f"{which}_metrics"][k]
            - report["reference"][f"{which}_metrics"][k]
            for which in ("best_ckpt", "final") for k in ("f1", "mcc")
            if f"{which}_metrics" in report}
    return report


# ---------------------------------------------------------------------------

def _device_fields(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(device)}
    return {"platform": device.type, "device": device.type}


def _finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--geometry", choices=("small", "canonical"),
                        default="small")
    parser.add_argument("--out", default=None,
                        help="default QUALITY_torch.json / "
                             "CANONICAL_torch.json (a smoke run: "
                             "<geometry>_torch_smoke.json)")
    parser.add_argument("--device", default=None,
                        help="torch device; the GPU when omitted (raises "
                             "without one), 'cpu' for the plain path")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--tiny", action="store_true",
                        help="canonical geometry at the small one's shape "
                             "and widths (a CPU run)")
    parser.add_argument("--verbose", action="store_true")
    # small geometry (tools/quality_parity.py)
    parser.add_argument("--seeds", type=int, nargs="*",
                        default=[0, 1, 2, 3, 4, 5])
    parser.add_argument("--epochs1", type=int, default=20)
    parser.add_argument("--epochs2", type=int, default=60)
    parser.add_argument("--n-test", type=int, default=512)
    # canonical geometry (tools/canonical_convergence.py, CANONICAL_r04)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-train", type=int, default=256)
    parser.add_argument("--n-val", type=int, default=64)
    parser.add_argument("--val-every", type=int, default=2)
    parser.add_argument("--n-test-canonical", type=int, default=192)
    parser.add_argument("--epochs1-canonical", type=int, default=10)
    parser.add_argument("--epochs2-canonical", type=int, default=20)
    parser.add_argument("--warm-epochs", type=int, default=3)
    parser.add_argument("--mixed-precision", choices=("bf16", "none"),
                        default="bf16",
                        help="both stages' compute dtype (the script's bf16)")
    parser.add_argument("--stage1-npz", default=None,
                        help="the Stage-1 generator's npz: loaded, and Stage "
                             "1 skipped, when it exists; else written after "
                             "Stage 1 (a run split at the stage boundary)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    t0 = time.perf_counter()
    try:
        if args.geometry == "small":
            # f32 throughout, as JAX's run under --matmul-precision highest
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            report = run_small(args, device)
        else:
            args.n_test = args.n_test_canonical
            report = run_canonical(args, device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    report["wall_seconds"] = time.perf_counter() - t0
    if not _finite({k: v for k, v in report.items() if k != "reference"}):
        raise SystemExit("quality_torch: a metric is not finite")
    out = args.out or (f"{args.geometry}_torch_smoke.json" if args.smoke
                       else {"small": "QUALITY_torch.json",
                             "canonical": "CANONICAL_torch.json"}[
                                 args.geometry])
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    summary = {k: report[k] for k in ("gfe_mamba_torch", "metrics",
                                      "best_ckpt_metrics", "comparison")
               if k in report}
    print(json.dumps(summary), flush=True)
    return report


if __name__ == "__main__":
    main()
