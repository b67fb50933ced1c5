#!/usr/bin/env python
"""Where the time of one of the port's canonical paths goes, on one GPU.

    python3 profile_torch.py [--path serve|stage2|stage1|seg_forward|seg_step]
        [--mixer mamba|jamba|transformer] [TRACE.json]

``serve`` (the default) builds the canonical pipeline (``bench.py``'s
configuration: 160x160x96, bf16, batch 4, random weights from seed 0)
with the ``--mixer`` classifier head (Mamba by default) and runs
requests; ``stage2`` runs ``ClassifyTrainer`` steps on it (bf16, batch
1); ``stage1`` runs ``GanTrainer`` steps over the canonical
generator, ``PatchDiscriminator(3, 32)`` and ``PerceptualLoss(0.25)``
(bf16, batch 1, adversary on); ``seg_forward`` runs the segmentation
UNet3D at ``get_model``'s defaults (f_maps 64, 4 levels) in f32 (TF32
off) on ``seg_predict``'s batch of 4 patches of 64x128x128, and
``seg_step`` runs ``UNetTrainer`` steps on it (batch 1, BCEDiceLoss,
Adam).  After two warm-up iterations it traces
two more with ``torch.profiler`` (CPU and CUDA activities) and prints the
host time per iteration; the device's busy time, the union of its
operations' intervals inside the profiled iterations, and its idle
share, 1 - busy over that wall (as ``portbench``'s ``device_idle.*``);
the number of kernel launches; the kernels by device time with each
one's share; the port's own kernels (``csrc/*.cu``) wherever they rank;
and, on the training paths, the host time of each of the program's
``gfe.*`` spans per iteration (``gfe_mamba_torch/utils/profiling.py``;
the spans of autograd's device thread, ``gfe.conv3d.dz`` / ``.dw`` and
``gfe.scan.bwd``, among them).  With a file name it also writes the
chrome trace there.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
IMG = (160, 160, 96)
BATCH = 4
SEG_PATCH = (64, 128, 128)
REQUESTS = 2
WINDOW = "profile.window"   # the range around the profiled iterations
CATEGORIES = dict(categories=(6,) * 8, num_continuous=40)
# the kernels of gfe_mamba_torch/csrc, as the profiler names them
# ("void (anonymous namespace)::scan_kernel<16>(...)"; a kernel that is
# not a template has no "void")
PORT_KERNELS = re.compile(
    r"^(void )?\(anonymous namespace\)::"
    r"(conv_mma|conv_fma|dw_mma|dw_fma|scan|scan_bwd|finish|stats|apply)"
    r"_kernel[<(]")


def device_busy(events) -> tuple[int, int]:
    """Nanoseconds in which some device operation runs inside the
    ``WINDOW`` range (the union of the operations' intervals, not a sum
    of their times), and the range's length."""
    from torch.autograd import DeviceType

    w0 = w1 = None
    ops = []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
        elif not e.is_user_annotation():
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    busy, end = 0, w0
    for s, e in sorted(ops):
        s, e = max(s, end), min(e, w1)
        if e > s:
            busy += e - s
            end = e
    return busy, w1 - w0


def _work(path: str, mixer: str, gen: torch.Generator):
    """One iteration of ``path`` as a closure over freshly built models."""
    from gfe_mamba_torch.models.pipeline import (build_generator,
                                                 build_gfe_mamba)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if path.startswith("seg"):
        return _seg_work(path, randn)

    if path == "serve":
        model = build_gfe_mamba(img_size=IMG, dtype=torch.bfloat16, seed=0,
                                mixer=mixer, **CATEGORIES)

        def request():
            x_cat = torch.randint(0, 6, (BATCH, 8), generator=gen,
                                  device="cuda")
            with torch.inference_mode():
                model(randn(BATCH, *IMG, 1).to(torch.bfloat16), x_cat,
                      randn(BATCH, 40).to(torch.bfloat16), return_pet=True)
        return request
    if path == "stage2":
        from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
        trainer = ClassifyTrainer(build_gfe_mamba(img_size=IMG, seed=0,
                                                  mixer=mixer, **CATEGORIES))

        def step():
            x_cat = torch.randint(0, 6, (1, 8), generator=gen, device="cuda")
            trainer.train_step(randn(1, *IMG, 1), x_cat, randn(1, 40),
                               torch.ones(1, device="cuda"))
        return step
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer
    disc = PatchDiscriminator(3, 32)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    trainer = GanTrainer(build_generator(seed=0), disc,
                         PerceptualLoss(0.25))
    return lambda: trainer.train_step(randn(1, *IMG, 1), randn(1, *IMG, 1),
                                      1.0)


def _seg_work(path: str, randn):
    from gfe_mamba_torch.models.unet3d import get_model
    from gfe_mamba_torch.segmentation.trainer import UNetTrainer

    torch.backends.cudnn.allow_tf32 = False
    model = get_model(dict(name="UNet3D", in_channels=1, out_channels=1,
                           f_maps=64, layer_order="gcr", num_groups=8))
    if path == "seg_forward":
        model.to("cuda")

        def forward():
            with torch.inference_mode():
                model(randn(BATCH, *SEG_PATCH, 1))
        return forward
    ckpt = tempfile.TemporaryDirectory()       # the trainer makes it; no save
    trainer = UNetTrainer(model, {"loss": {"name": "BCEDiceLoss"},
                                  "eval_metric": {"name": "DiceCoefficient"}},
                          checkpoint_dir=ckpt.name)
    trainer.init_state(0)

    def step():
        trainer.train_step(randn(1, *SEG_PATCH, 1),
                           (randn(1, *SEG_PATCH, 1) > 0).float())
    step.ckpt = ckpt
    return step


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("serve", "stage2", "stage1",
                                            "seg_forward", "seg_step"),
                        default="serve")
    parser.add_argument("--mixer", choices=("mamba", "jamba", "transformer"),
                        default="mamba", help="the classifier head of the "
                        "serve and stage2 paths")
    parser.add_argument("trace", nargs="?", help="chrome trace to write")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device available", flush=True)
        return 1
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gfe_mamba_torch.utils.profiling import annotate

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    work = _work(args.path, args.mixer,
                 torch.Generator(device="cuda").manual_seed(0))
    for _ in range(2):
        work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with annotate(WINDOW):
            for _ in range(REQUESTS):
                work()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / REQUESTS
    rows = []
    for evt in prof.key_averages():
        # device-side events only: operator rows repeat their kernels' time,
        # and so do annotations such as Optimizer.step on the device track
        if evt.device_type != DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False) \
                or evt.key.startswith("Optimizer."):
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / REQUESTS, evt.count // REQUESTS,
                         evt.key))
    rows.sort(reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    busy, window = device_busy(prof.profiler.kineto_results.events())
    what = args.path if args.path.startswith("seg") \
        else f"{args.path} ({args.mixer})"
    print(f"{card}: {what} {wall_ms:.2f} ms per "
          f"iteration (host "
          f"clock), device busy {busy / 1e6 / REQUESTS:.2f} ms, idle share "
          f"{1 - busy / window:.3f} of the profiled "
          f"{window / 1e6 / REQUESTS:.2f} ms, "
          f"{sum(r[1] for r in rows)} kernel launches")
    print(f"{'ms/iter':>10} {'share':>6} {'calls':>5}  kernel")
    for ms, calls, key in rows[:30]:
        print(f"{ms:10.3f} {ms / kernel_ms:6.3f} {calls:5d}  {key[:110]}")
    print("the port's own kernels (csrc/*.cu):")
    for ms, calls, key in rows:
        if PORT_KERNELS.match(key):
            print(f"{ms:10.4f} {ms / kernel_ms:6.3f} {calls:5d}  {key[:110]}")
    if args.path in ("stage2", "stage1", "seg_step"):
        print("the program's spans, host ms per iteration:")
        for evt in sorted(prof.key_averages(), key=lambda e: e.key):
            # host rows only: each span also has a row on the device track
            if evt.key.startswith("gfe.") \
                    and evt.device_type == DeviceType.CPU:
                print(f"{evt.cpu_time_total / 1e3 / REQUESTS:10.3f} "
                      f"{evt.count / REQUESTS:7.1f}  {evt.key}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
