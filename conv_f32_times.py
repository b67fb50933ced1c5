#!/usr/bin/env python
"""Time K1's and K3's f32 variants, conv by conv, on one NVIDIA GPU.

    python3 conv_f32_times.py [--tree DIR] [--out FILE.json] [--reps N]

The shapes are the segmentation path's: the 13 K1 convs of ``get_model``'s
UNet3D (f_maps 64, 4 levels) on one 64x128x128 patch at batch 1, each as
the forward (the folded GroupNorm and relu), as the input gradient K1-dz
(the cotangent through the flipped, transposed weights) and as K3's weight
gradient (with the GroupNorm affine); then the generator's three f32
levels (C = F = 64, 128, 256, batch 1).  Beside each: the plain version
of the forward, cuDNN's f32 conv, dgrad and wgrad (TF32 off), the bound
(operations at the H100's 67 TFLOP/s FFMA peak, or bytes at 3.35 TB/s),
each kernel's TFLOP/s and share of that peak, and its error against its
plain version (relative to max(1, max |plain|)).  Times are CUDA events
over ``--reps`` calls after one warm-up (``chip_smoke.py``'s helpers).

``--tree`` imports ``gfe_mamba_torch`` from another checkout (an unpacked
parent commit, say) so that two versions of the kernels can be timed in
turns on one card; its kernels build into that checkout's ``_build``.
Prints one line per shape, the totals per UNet3D forward and training
step, the SM clock and power that ``nvidia-smi`` reads while K1 runs the
largest conv for about two seconds (the FFMA peak at that clock is
128 x 2 operations per cycle per SM), the card's name and power limit,
and writes the same as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

from chip_smoke import (HBM_BYTES_PER_S, PEAK_F32, card_line,
                        cudnn_conv_grad, rel_err, time_ms)

# UNet3D's K1 convs at f_maps 64 on a 64x128x128 patch, batch 1: (spatial,
# C, F) in forward order (the C_in = 1 stem runs on cuDNN)
UNET3D_CONVS = (
    ((64, 128, 128), 32, 64), ((32, 64, 64), 64, 64),
    ((32, 64, 64), 64, 128), ((16, 32, 32), 128, 128),
    ((16, 32, 32), 128, 256), ((8, 16, 16), 256, 256),
    ((8, 16, 16), 256, 512), ((16, 32, 32), 768, 256),
    ((16, 32, 32), 256, 256), ((32, 64, 64), 384, 128),
    ((32, 64, 64), 128, 128), ((64, 128, 128), 192, 64),
    ((64, 128, 128), 64, 64))
GENERATOR_CONVS = (((160, 160, 96), 64, 64), ((80, 80, 48), 128, 128),
                   ((40, 40, 24), 256, 256))


def time_shape(kc, spatial, C, F, gen, reps) -> dict:
    dev = "cuda"
    vox = math.prod(spatial)
    x = torch.randn(1, *spatial, C, generator=gen, device=dev)
    w = torch.randn(3, 3, 3, C, F, generator=gen, device=dev) \
        * (27 * C) ** -0.5
    a = torch.rand(1, C, generator=gen, device=dev) + 0.5
    s = torch.randn(1, C, generator=gen, device=dev)
    g1 = torch.randn(1, *spatial, F, generator=gen, device=dev)
    wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    zhat = kc.affine_in_dtype(x, a, s)
    xc = zhat.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    flops = 2 * vox * 27 * C * F
    nbytes = 4 * (vox * (C + F) + 27 * C * F) + 8 * C
    bound = max(flops / PEAK_F32, nbytes / HBM_BYTES_PER_S) * 1e3
    row = dict(spatial=list(spatial), C=C, F=F, gflop=flops / 1e9,
               bound_ms=bound)
    runs = {
        "k1": (lambda: kc.conv3x3x3_cuda(x, w, None, a, s, None, "relu"),
               lambda: kc.conv3x3x3_plain(x, w, None, a, s, None, "relu")),
        "dz": (lambda: kc.conv3x3x3_cuda(g1, wf),
               lambda: kc.conv3x3x3_plain(g1, wf)),
        "k3": (lambda: kc.conv3x3x3_dw_cuda(x, g1, a, s),
               lambda: kc.conv3x3x3_dw_plain(x, g1, a, s)),
    }
    for name, (kernel, plain) in runs.items():
        row[f"{name}_rel_err"] = rel_err(kernel(), plain())[1]
        ms = time_ms(kernel, reps)
        row[f"{name}_ms"] = ms
        row[f"{name}_tflops"] = flops / ms / 1e9
        row[f"{name}_peak_share"] = flops / ms / 1e-3 / PEAK_F32
    row["k1_plain_ms"] = time_ms(runs["k1"][1], reps)
    row["cudnn_conv_ms"] = time_ms(
        lambda: torch.nn.functional.conv3d(xc, wc, padding=1), reps)
    row["cudnn_dgrad_ms"] = time_ms(
        lambda: cudnn_conv_grad(zhat, w, g1, "x"), reps)
    row["cudnn_wgrad_ms"] = time_ms(
        lambda: cudnn_conv_grad(zhat, w, g1, "w"), reps)
    return row


def clock_under_load(fn) -> dict:
    """Median SM clock (MHz) and power (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back for about two seconds."""
    import statistics
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(2.0 / (time.perf_counter() - t)))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    time.sleep(0.3)
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    rows = [list(map(float, line.split(","))) for line in out.splitlines()
            if line.strip()]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = statistics.median(r[0] for r in rows)
    return dict(sm_mhz=mhz, power_w=statistics.median(r[1] for r in rows),
                samples=len(rows), ffma_peak_tflops=sms * 256 * mhz / 1e6)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    parser.add_argument("--out")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("conv_f32_times: no CUDA device available", flush=True)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from gfe_mamba_torch.ops.cuda import build
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build.build(("conv3d", "conv3d_dw"))
    print(f"tree {args.tree}: kernels from {kc.__file__} on {card}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = dict(tree=args.tree, card=card, unet3d=[], generator=[])
    for key, convs in (("unet3d", UNET3D_CONVS),
                       ("generator", GENERATOR_CONVS)):
        for spatial, C, F in convs:
            row = time_shape(kc, spatial, C, F, gen, args.reps)
            result[key].append(row)
            print(f"{key} {spatial}x{C}->{F}: " + ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k not in ("spatial", "C", "F")),
                flush=True)
            torch.cuda.empty_cache()
    totals = {}
    for key in ("k1_ms", "dz_ms", "k3_ms", "k1_plain_ms", "cudnn_conv_ms",
                "cudnn_dgrad_ms", "cudnn_wgrad_ms", "bound_ms", "gflop"):
        totals[key] = sum(r[key] for r in result["unet3d"])
    for name in ("k1", "dz", "k3"):
        totals[f"{name}_tflops"] = totals["gflop"] / totals[f"{name}_ms"]
        totals[f"{name}_peak_share"] = \
            totals[f"{name}_tflops"] * 1e12 / PEAK_F32
        totals[f"{name}_worst_rel_err"] = max(
            r[f"{name}_rel_err"] for r in result["unet3d"])
    result["unet3d_totals"] = totals
    spatial, C, F = UNET3D_CONVS[-2]                 # 192 -> 64, full size
    x = torch.randn(1, *spatial, C, generator=gen, device="cuda")
    w = torch.randn(3, 3, 3, C, F, generator=gen, device="cuda")
    result["clock"] = clock_under_load(lambda: kc.conv3x3x3_cuda(x, w))
    print(f"K1 at {spatial}x{C}->{F} for ~2 s: {result['clock']}",
          flush=True)
    del x, w
    print("UNet3D per forward / step (13 convs, batch 1): " + ", ".join(
        f"{k}={v:.4g}" for k, v in totals.items()) + f" [{card}]",
        flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
