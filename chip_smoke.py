#!/usr/bin/env python
"""Time the port's CUDA kernels on one NVIDIA GPU: the figures of the
kernel table in ``PERF.md``.

    python3 chip_smoke.py [--tree DIR]

It builds the five sources of ``gfe_mamba_torch/csrc`` and reports each
kernel function's registers per thread and spilled bytes, and K2's
resident blocks per SM.  Then, for each kernel on the paths it serves, it
times the kernel beside its bound (the least time the H100 could take:
bytes over 3.35 TB/s or operations over the peak rate of their type),
its plain PyTorch version and the library call that computes the same
function, where there is one:

- K1 in bf16 per scoring request (the generator's 10 convs at batch 4),
  and as the input gradient (dz) per Stage-1 step (10 convs at batch 1);
- K1 and K3 in f32 per UNet3D forward and training step (its 13 K1
  convs at batch 1 on a 64x128x128 patch: forward, dz, weight gradient);
- K3 in bf16 per Stage-1 step (10 convs at batch 1, the GN affine on);
- K2's short kernel at (4, 53, 1024, 16) (6 calls per scoring request)
  on a Mamba layer's bf16 operands, and its long kernel at (1, 15024 |
  4467, 8192, 16) on a Jamba2-Mini layer's;
- K4 per Stage-2 step (6 calls at (1, 53, 1024, 16)) on the f32 views
  the bf16 step hands it;
- K5a and K5b over the generator's three GroupNorm widths (batch 4, bf16).

Each call is held to its plain version at its shape before it is timed,
at the card tests' tolerances, so that no wrong kernel is timed.  Times
are CUDA events over 5 calls after a warm-up (K5: 20); K2's and K4's are
their device time alone, one CUDA graph of 50 calls (10 at the long
lengths) replayed.

Each kernel's entry also carries its ``launches`` on the main paths,
untimed: a scoring request (batch 4), a Stage-2 and a Stage-1 step
(batch 1), the prefill of a Jamba2-Mini-shaped stack over a 4,467-token
prompt, a UNet3D forward and step (64x128x128, batch 1) and one
``group_norm_act`` call (K5's only caller), each built at the
benchmark's size by ``gfe_mamba_torch/testing.py`` and counted over one
request or step after a warm-up one.  The card's name and power limit
are logged; the last line is ``{"kernels": [...]}``, one entry per
kernel.  The checks of the port on the card are the ``cuda``-marked
tests, ``python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py
-q``.

``--tree DIR`` imports ``gfe_mamba_torch`` from another checkout (an
unpacked parent commit, say), so that two versions of the kernels can be
timed in turns on one card; its kernels build into that checkout's
``_build``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import torch

PEAK_BF16 = 989e12        # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12          # H100 SXM FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SCORE_BATCH = 4
# the generator's 3x3x3 convs per forward: (spatial, channels, count)
CONV_LEVELS = (((160, 160, 96), 64, 4), ((80, 80, 48), 128, 4),
               ((40, 40, 24), 256, 2))
# the 13 K1 convs of ``get_model``'s UNet3D (f_maps 64, 4 levels) on one
# 64x128x128 patch at batch 1, (spatial, C, F) in forward order; the
# C_in = 1 stem runs on cuDNN
UNET3D_K1_CONVS = (
    ((64, 128, 128), 32, 64), ((32, 64, 64), 64, 64),
    ((32, 64, 64), 64, 128), ((16, 32, 32), 128, 128),
    ((16, 32, 32), 128, 256), ((8, 16, 16), 256, 256),
    ((8, 16, 16), 256, 512), ((16, 32, 32), 768, 256),
    ((16, 32, 32), 256, 256), ((32, 64, 64), 384, 128),
    ((32, 64, 64), 128, 128), ((64, 128, 128), 192, 64),
    ((64, 128, 128), 64, 64))
# the canonical Mamba head: d_model 512 (ED 1024, N 16), 53 tokens, 6
# layers; Jamba2-Mini's Mamba layers (d_model 4096) at the longest and the
# shortest docqa prompt
SCAN_D_MODEL, SCAN_L, SCAN_CALLS = 512, 53, 6
LONG_D_MODEL, LONG_LENGTHS = 4096, (15024, 4467)
SOURCES = {"K1": "conv3d", "K3": "conv3d_dw", "K2": "selective_scan",
           "K4": "selective_scan_bwd", "K5a": "group_norm",
           "K5b": "group_norm"}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50) -> float:
    """Device time per call of ``fn`` alone: ``reps`` calls captured in one
    CUDA graph, whose replay (after one warm-up replay) is timed by CUDA
    events, 3 replays averaged.  The wrapper's host work is not in it; the
    inputs stay in the L2 cache between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def check(got, want, rel: float) -> None:
    """max |got - want| within ``rel`` of max(1, max |want|)."""
    want = want.detach().to(got.device).float()
    err = (got.detach().float() - want).abs().max().item()
    if not err <= rel * max(1.0, want.abs().max().item()):
        raise AssertionError(f"kernel and plain version differ: {err}")


def bound(flops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def add(total: dict, row: dict, count: int = 1) -> None:
    """``row``'s times, ``count`` times over, summed into ``total``."""
    for key, value in row.items():
        if key.endswith("_ms") or key == "ms":
            total[key] = total.get(key, 0.0) + count * value


def cudnn_conv_grad(x, w, g, which):
    """cuDNN's wgrad (``which="w"``) or dgrad (``"x"``) of the same 3x3x3
    conv on channels_last_3d tensors: the library yardstick, never called
    by the port."""
    wt = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    mask = [which == "x", which == "w", False]
    return torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), wt, None,
        [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, mask)


def cudnn_conv(x, w):
    """cuDNN's forward of the same conv, channels_last_3d."""
    wc = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    xc = x.permute(0, 4, 1, 2, 3)
    return lambda: torch.nn.functional.conv3d(xc, wc, padding=1)


def conv_inputs(gen, shape, C, F, dtype):
    """x, w, the GN affine (a, s), a cotangent or residual of F channels."""
    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda")
    return (r(*shape, C).to(dtype), (r(3, 3, 3, C, F) * (27 * C) ** -0.5)
            .to(dtype), torch.rand(shape[0], C, generator=gen,
                                   device="cuda") + 0.5,
            r(shape[0], C), r(*shape, F).to(dtype))


def k1_bf16(kc, gen) -> list[dict]:
    """K1 per scoring request (GN+conv+relu and GN+conv+residual+relu at
    each level, batch 4) and as dz per Stage-1 step (batch 1, no GN)."""
    request, dz = {}, {}
    for spatial, C, count in CONV_LEVELS:
        for residual in (False, True):
            x, w, a, s, res = conv_inputs(gen, (SCORE_BATCH, *spatial), C, C,
                                          torch.bfloat16)
            args = (x, w, None, a, s, res if residual else None,
                    "none" if residual else "relu",
                    "relu" if residual else "none")
            check(kc.conv3x3x3_cuda(*args), kc.conv3x3x3_plain(*args), 3e-2)
            vox = SCORE_BATCH * math.prod(spatial)
            add(request, dict(
                ms=time_ms(lambda: kc.conv3x3x3_cuda(*args)),
                plain_ms=time_ms(lambda: kc.conv3x3x3_plain(*args)),
                library_ms=time_ms(cudnn_conv(x, w)),
                **bound(2 * vox * 27 * C * C, PEAK_BF16,
                        2 * (vox * C + 27 * C * C
                             + vox * C * (2 if residual else 1))
                        + 8 * SCORE_BATCH * C)), count // 2)
            del x, w, a, s, res, args
        g1, w, _, _, _ = conv_inputs(gen, (1, *spatial), C, C,
                                     torch.bfloat16)
        wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        check(kc.conv3x3x3_cuda(g1, wf), kc.conv3x3x3_plain(g1, wf), 3e-2)
        vox = math.prod(spatial)
        add(dz, dict(ms=time_ms(lambda: kc.conv3x3x3_cuda(g1, wf)),
                     plain_ms=time_ms(lambda: kc.conv3x3x3_plain(g1, wf)),
                     library_ms=time_ms(
                         lambda: cudnn_conv_grad(g1, w, g1, "x")),
                     **bound(2 * vox * 27 * C * C, PEAK_BF16,
                             2 * (2 * vox * C + 27 * C * C) + 8 * C)), count)
        del g1, w, wf
        torch.cuda.empty_cache()
    return [dict(request, per="scoring request: 10 convs at batch 4, bf16",
                 library="cuDNN conv3d", bound_by="operations"),
            dict(dz, per="Stage-1 step, dz: 10 convs at batch 1, bf16",
                 library="cuDNN dgrad", bound_by="operations")]


def k3_bf16(kc, gen) -> dict:
    """K3 per Stage-1 step: the 10 convs' weight gradients at batch 1 with
    the GN affine, beside cuDNN's wgrad of the affine-applied input."""
    step = {}
    for spatial, C, count in CONV_LEVELS:
        x, w, a, s, g1 = conv_inputs(gen, (1, *spatial), C, C,
                                     torch.bfloat16)
        check(kc.conv3x3x3_dw_cuda(x, g1, a, s),
              kc.conv3x3x3_dw_plain(x, g1, a, s), 1e-4)
        zhat = kc.affine_in_dtype(x, a, s)
        vox = math.prod(spatial)
        add(step, dict(
            ms=time_ms(lambda: kc.conv3x3x3_dw_cuda(x, g1, a, s)),
            plain_ms=time_ms(lambda: kc.conv3x3x3_dw_plain(x, g1, a, s),
                             reps=2),
            library_ms=time_ms(lambda: cudnn_conv_grad(zhat, w, g1, "w")),
            **bound(2 * vox * 27 * C * C, PEAK_BF16,
                    4 * vox * C + 4 * 27 * C * C + 8 * C)), count)
        del x, w, a, s, g1, zhat
        torch.cuda.empty_cache()
    return dict(step, per="Stage-1 step: 10 convs at batch 1, bf16",
                library="cuDNN wgrad", bound_by="operations")


def f32_unet3d(kc, gen) -> tuple[dict, dict, dict]:
    """K1 (the folded GN and relu), K1 as dz and K3 (with the GN affine)
    in f32 at UNet3D's 13 conv shapes, batch 1, TF32 off for cuDNN."""
    forward, dz, dw = {}, {}, {}
    for spatial, C, F in UNET3D_K1_CONVS:
        x, w, a, s, g1 = conv_inputs(gen, (1, *spatial), C, F, torch.float32)
        wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        zhat = kc.affine_in_dtype(x, a, s)
        vox = math.prod(spatial)
        costs = bound(2 * vox * 27 * C * F, PEAK_F32,
                      4 * (vox * (C + F) + 27 * C * F) + 8 * C)
        for total, kernel, plain, library in (
                (forward,
                 lambda: kc.conv3x3x3_cuda(x, w, None, a, s, None, "relu"),
                 lambda: kc.conv3x3x3_plain(x, w, None, a, s, None, "relu"),
                 cudnn_conv(zhat, w)),
                (dz, lambda: kc.conv3x3x3_cuda(g1, wf),
                 lambda: kc.conv3x3x3_plain(g1, wf),
                 lambda: cudnn_conv_grad(zhat, w, g1, "x")),
                (dw, lambda: kc.conv3x3x3_dw_cuda(x, g1, a, s),
                 lambda: kc.conv3x3x3_dw_plain(x, g1, a, s),
                 lambda: cudnn_conv_grad(zhat, w, g1, "w"))):
            check(kernel(), plain(), 1e-4)
            add(total, dict(ms=time_ms(kernel),
                            plain_ms=time_ms(plain, reps=2),
                            library_ms=time_ms(library), **costs))
        del x, w, a, s, g1, wf, zhat
        torch.cuda.empty_cache()
    per = "UNet3D {}: 13 convs at batch 1 on 64x128x128, f32"
    return (dict(forward, per=per.format("forward"),
                 library="cuDNN conv3d (TF32 off)", bound_by="operations"),
            dict(dz, per=per.format("step, dz"),
                 library="cuDNN dgrad (TF32 off)", bound_by="operations"),
            dict(dw, per=per.format("step"),
                 library="cuDNN wgrad (TF32 off)", bound_by="operations"))


def scan_bytes_ops(args, outputs, per_element: int) -> tuple[int, int]:
    bsz, L, ED = args[0].shape
    return (bsz * L * ED * per_element, nbytes(*args, *outputs))


def k2_short(k2, testing) -> dict:
    """K2 on a canonical Mamba layer's bf16 operands at batch 4 (channel-
    major x, z, B and C views), one bf16 ulp of the plain f32 result; ~6N
    + 10 f32 operations per (b, t, e)."""
    args = testing.mamba_scan_operands(SCORE_BATCH, SCAN_L, SCAN_D_MODEL,
                                       torch.bfloat16, "cuda", seed=4)
    y = k2.selective_scan_cuda(*args, delta_softplus=True)
    if not testing.bf16_ulps(y, k2.selective_scan_plain(
            *[t.float() for t in args], delta_softplus=True)) <= 1.0:
        raise AssertionError("K2 (short) and its plain version differ")
    ops, moved = scan_bytes_ops(args, [y], 6 * 16 + 10)
    return dict(per=f"call at (4, 53, 1024, 16) on bf16 views; "
                    f"{SCAN_CALLS} per scoring request",
                ms=graph_ms(lambda: k2.selective_scan_cuda(
                    *args, delta_softplus=True)),
                plain_ms=time_ms(lambda: k2.selective_scan_plain(
                    *[t.float() for t in args], delta_softplus=True)),
                library_ms=None, library="none",
                **bound(ops, PEAK_F32, moved))


def k2_long(k2, testing, L: int) -> dict:
    """K2's long kernel on a Jamba2-Mini layer's bf16 operands: one long
    launch, y within one bf16 ulp and the last state within 1e-5 of the
    plain loop."""
    args = testing.mamba_scan_operands(1, L, LONG_D_MODEL, torch.bfloat16,
                                       "cuda", seed=L)
    plain = [t.float() for t in args]
    before = k2.long_launches
    y, h = k2.selective_scan_cuda(*args, delta_softplus=True,
                                  return_state=True)
    want, want_h = k2.selective_scan_plain(*plain, delta_softplus=True,
                                           return_state=True)
    if not (k2.long_launches - before == 1
            and testing.bf16_ulps(y, want) <= 1.0):
        raise AssertionError(f"K2 (long) and its plain version differ at {L}")
    check(h, want_h, 1e-5)
    del want, want_h
    ops, moved = scan_bytes_ops(args, [y], 6 * 16 + 10)
    row = dict(per=f"call at (1, {L}, 8192, 16) on bf16 views; 7 per "
                   f"docqa prefill",
               ms=graph_ms(lambda: k2.selective_scan_cuda(
                   *args, delta_softplus=True), reps=10),
               plain_ms=time_ms(lambda: k2.selective_scan_plain(
                   *[t.float() for t in args], delta_softplus=True), reps=1),
               library_ms=None, library="none",
               **bound(ops, PEAK_F32, moved))
    del args, plain, y, h
    torch.cuda.empty_cache()
    return row


def k4_stage2(k2, testing) -> dict:
    """K4 per Stage-2 step on the bf16 step's operands (f32 x, delta, z,
    B, C views; bf16 D and delta_bias) at batch 1: every gradient within
    1e-4 of the plain loops; ~20N + 30 operations per (b, t, e)."""
    args = testing.mamba_scan_operands(1, SCAN_L, SCAN_D_MODEL,
                                       torch.bfloat16, "cuda", seed=21,
                                       input_dtype=torch.float32)
    g = torch.randn(1, SCAN_L, 2 * SCAN_D_MODEL, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(21))
    grads = k2.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    for got, want in zip(grads, k2.selective_scan_bwd_plain(
            *[t.float() for t in args], g, delta_softplus=True)):
        check(got, want, 1e-4)
    ops, moved = scan_bytes_ops(args, [g, *grads], 20 * 16 + 30)
    row = dict(ms=graph_ms(lambda: k2.selective_scan_bwd_cuda(
                   *args, g, delta_softplus=True)),
               plain_ms=time_ms(lambda: k2.selective_scan_bwd_plain(
                   *[t.float() for t in args], g, delta_softplus=True)),
               **bound(ops, PEAK_F32, moved))
    step = {}
    add(step, row, SCAN_CALLS)
    return dict(step, per="Stage-2 step: 6 calls at (1, 53, 1024, 16) on "
                          "the bf16 step's f32 views", library_ms=None,
                library="none", bound_by=row["bound_by"])


def k5(gen) -> list[dict]:
    """K5a (statistics) and K5b (apply + elu) at the generator's three
    GroupNorm widths, batch 4, bf16, 8 groups: K5a within 1e-5 and K5b
    within 2^-7 of their plain versions (K5b on the plain sums' fold);
    beside ``group_norm_stats`` and ``F.group_norm`` + elu."""
    from gfe_mamba_torch.ops.conv3d import group_norm_stats
    from gfe_mamba_torch.ops.cuda import group_norm as kg
    from gfe_mamba_torch.ops.group_norm import fold_group_stats

    stats, apply = {}, {}
    for spatial, C, _ in CONV_LEVELS:
        shape = (SCORE_BATCH, *spatial, C)
        x = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
        scale = torch.randn(C, generator=gen, device="cuda")
        bias = torch.randn(C, generator=gen, device="cuda")
        xv = x.reshape(SCORE_BATCH, -1, C)
        sums = kg.group_norm_sums_plain(xv)
        check(kg.group_norm_sums_cuda(xv), sums, 1e-5)
        mean, inv = fold_group_stats(sums, xv.shape[1], 8, 1e-5)
        check(kg.group_norm_apply_cuda(xv, mean, inv, scale, bias, "elu"),
              kg.group_norm_apply_plain(xv, mean, inv, scale, bias, "elu"),
              2.0 ** -7)
        n = x.numel()

        def library():
            y = torch.nn.functional.group_norm(
                x.permute(0, 4, 1, 2, 3), 8, scale.bfloat16(),
                bias.bfloat16(), 1e-5)
            return torch.nn.functional.elu(y)

        add(stats, dict(
            ms=time_ms(lambda: kg.group_norm_sums_cuda(xv), reps=20),
            plain_ms=time_ms(lambda: kg.group_norm_sums_plain(xv)),
            library_ms=time_ms(lambda: group_norm_stats(x, 8)),
            **bound(2 * n, PEAK_F32, 2 * n + 8 * SCORE_BATCH * C)))
        add(apply, dict(
            ms=time_ms(lambda: kg.group_norm_apply_cuda(
                xv, mean, inv, scale, bias, "elu"), reps=20),
            plain_ms=time_ms(lambda: kg.group_norm_apply_plain(
                xv, mean, inv, scale, bias, "elu")),
            library_ms=time_ms(library),
            **bound(6 * n, PEAK_F32, 4 * n + 16 * SCORE_BATCH * C)))
        del x, xv, sums, mean, inv
        torch.cuda.empty_cache()
    per = "one call at each of the three generator widths, batch 4, bf16"
    return [dict(stats, per=per, library="group_norm_stats",
                 bound_by="bytes"),
            dict(apply, per=per, library="F.group_norm + elu (K5a and K5b "
                 "together)", bound_by="bytes")]


def unet3d_trainer(testing, root: str):
    """``UNetTrainer`` over the benchmark's UNet3D in f32 (seed 0), BCEDice
    and Adam at 1e-4 as its cell, checkpointing under ``root``."""
    from gfe_mamba_torch.models.unet3d import get_model
    from gfe_mamba_torch.segmentation.trainer import UNetTrainer

    trainer = UNetTrainer(
        get_model(testing.UNET3D, seed=0).to("cuda"),
        {"loss": {"name": "BCEDiceLoss"},
         "eval_metric": {"name": "DiceCoefficient"},
         "optimizer": {"name": "Adam", "learning_rate": 1e-4}},
        root, device="cuda")
    trainer.init_state(0)
    return trainer


def path_launches(testing) -> dict:
    """Per kernel of the table, its launches on one request or step of
    each main path (after a warm-up one), ``{kernel: {path: {"all": n,
    variant: n}}}``, the variants those of ``testing.launch_counts``."""
    from gfe_mamba_torch.ops.group_norm import group_norm_act

    gen = torch.Generator(device="cuda")
    gn_shape = (SCORE_BATCH, *CONV_LEVELS[0][0], CONV_LEVELS[0][1])

    def unet3d_batch():
        raw = torch.randn(1, *testing.UNET3D_PATCH, 1, generator=gen,
                          device="cuda")
        return raw, (torch.rand(raw.shape, generator=gen, device="cuda")
                     > 0.5).float()

    def gn_call(_):
        x = torch.randn(*gn_shape, generator=gen, device="cuda").bfloat16()
        ones = torch.ones(gn_shape[-1], device="cuda")
        return group_norm_act(x, ones, ones, num_groups=8, act="elu")

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        paths = (
            ("scoring request", lambda: testing.scoring_model("cuda"),
             lambda m: testing.scoring_request(m, gen)),
            ("Stage-2 step", lambda: testing.stage2_trainer("cuda"),
             lambda t: testing.stage2_step(t, gen)),
            ("Stage-1 step", lambda: testing.stage1_trainer("cuda"),
             lambda t: testing.stage1_step(t, gen)),
            ("docqa prefill", lambda: (testing.jamba2_mini_stack("cuda"),
                                       testing.docqa_prompt("cuda")),
             lambda lp: lp[0].prefill(lp[1], 1)),
            ("UNet3D forward", lambda: unet3d_trainer(testing, root),
             lambda t: t.model(unet3d_batch()[0])),
            ("UNet3D step", lambda: unet3d_trainer(testing, root),
             lambda t: t.train_step(*unet3d_batch())),
            ("group_norm_act call", lambda: None, gn_call))
        for path, build, run in paths:
            built = build()
            gen.manual_seed(0)
            with torch.inference_mode(path.endswith(("prefill", "forward",
                                                     "call"))):
                run(built)
                torch.cuda.synchronize()
                before = testing.launch_counts()
                run(built)
                counts = testing.launches_since(before)
            for key, n in counts.items():
                if n:
                    name, _, variant = key.partition(".")
                    out.setdefault(name, {}).setdefault(path, {})[
                        variant or "all"] = n
            del built
            gc.collect()
            torch.cuda.empty_cache()
    return out


def ptxas_report(reports: dict) -> dict:
    """Per source, each kernel function's registers per thread and spilled
    bytes (stores + loads) from ``-Xptxas -v``, names demangled without
    their parameter lists."""
    out = {}
    for source, text in reports.items():
        functions, entry, props = {}, None, None
        for line in text.splitlines():
            found = re.search(r"entry function '(\S+)'", line)
            if found:
                entry = found.group(1)
            found = re.search(r"Function properties for (\S+)", line)
            if found:
                props = found.group(1)
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found and props:
                functions.setdefault(props, {})["spill_bytes"] = \
                    int(found.group(1)) + int(found.group(2))
            found = re.search(r"Used (\d+) registers", line)
            if found and entry:
                functions.setdefault(entry, {})["registers"] = \
                    int(found.group(1))
        names = list(functions)
        try:
            plain = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
        except (OSError, subprocess.CalledProcessError):
            plain = names
        out[source] = {
            re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", p):
            functions[n] for n, p in zip(names, plain)
            if "registers" in functions[n]}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from gfe_mamba_torch import testing
    from gfe_mamba_torch.ops.cuda import build
    from gfe_mamba_torch.ops.cuda import conv3d as kc
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{card_line()}; kernels from {kc.__file__}")
    build_info = ptxas_report(build.build())
    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = {"K1": k1_bf16(kc, gen)}
    forward, dz, dw = f32_unet3d(kc, gen)
    paths["K1"] += [forward, dz]
    paths["K3"] = [k3_bf16(kc, gen), dw]
    paths["K2"] = [k2_short(k2, testing),
                   *(k2_long(k2, testing, L) for L in LONG_LENGTHS)]
    paths["K4"] = [k4_stage2(k2, testing)]
    paths["K5a"], paths["K5b"] = ([row] for row in k5(gen))
    launches = path_launches(testing)
    kernels = []
    for name, rows in paths.items():
        if name not in launches:
            raise AssertionError(f"{name} launched on no path")
        entry = dict(name=name, source=f"csrc/{SOURCES[name]}.cu",
                     functions=build_info.get(SOURCES[name], {}), paths=rows,
                     launches=launches[name])
        if name == "K2":
            entry["blocks_per_sm"] = {"short (L 53)": k2.occupancy(53, 16),
                                      "long (L 15024)": k2.occupancy(15024,
                                                                     16)}
        kernels.append(entry)
        for row in rows:
            log(f"{name} {row['per']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()
                if isinstance(v, float)))
        log(f"{name} launches: {launches[name]}")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
