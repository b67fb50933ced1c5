#!/usr/bin/env python
"""Drive the PyTorch port of GFE-Mamba on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``gfe_mamba_torch/csrc`` (one ``nvcc`` per
   source, all at once), timed;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and ragged ones (K1: X and Y not
   multiples of its brick, Z = 24, C != F; K2: batch 4 and 1, ED 1000
   and 1001, every flag on and off in f32, and a canonical Mamba layer's
   bf16 operands as its forward hands them over (channel-major x, z, B
   and C views), y within one bf16 ulp of the plain f32 result rounded);
   each timed beside its bound (the least time the H100 could take: bytes
   over 3.35 TB/s or operations over the peak rate of their type) and,
   for K1, the cuDNN convolution; K2 by its device time alone (a CUDA
   graph of 50 calls) and through its wrapper, at batch 4 and 1, on the
   layer's bf16 operands and (logged) on contiguous f32 ones, beside the
   serial floor of its walk (logged);
4. pipeline parity: the full channel widths at a reduced volume in f32,
   the CPU (plain versions) against the card (kernels), same weights;
5. the main path: ``build_gfe_mamba`` at the canonical (160,160,96) bf16
   configuration serves 3 requests of batch 4; every forward must launch
   K1 10 times and K2 6 times;
6. the training kernels against their plain versions: K4 (scan
   backward) at (1|4, 53, 1024|1000|1001, 16) with every flag on and
   off in f32, and on a canonical Mamba layer's bf16 operands (dx,
   ddelta, dz within one bf16 ulp), a second call on those bitwise equal,
   timed like K2 at batch 1 and 4; K3
   (conv weight gradient) at the three generator levels (batch 1) and two
   ragged shapes (one with C != F) in f32 and bf16 with and without the
   GN affine (bf16 on the tensor-core variant, f32 on the CUDA-core one,
   a second bf16 call bitwise equal), K1 as the input gradient (flipped
   weights, no GN), and the conv autograd Function against autograd
   through the plain forward; each timed at the training shapes beside
   its bound and the cuDNN call that computes the same function (wgrad
   for K3, with K3 v1's time and the share of the bf16 peak; dgrad for
   K1's dz);
7. training parity: full widths, the reduced volume (64,64,32), f32,
   dropout off: one Stage-2 and three Stage-1 steps (order gcr with the
   adversary on, at two seeds; order gce with it off) on the CPU (plain
   versions) and on the card (kernels) from the same weights; losses and
   gradients must agree (``check_training_parity`` states each tolerance
   and why); each gcr step also runs a witness on the card with the plain
   convs in place of K1 and K3;
8. Stage 2 at the canonical size: ``ClassifyTrainer`` in bf16, batch 1,
   1 warm-up step then 3 steps; each must launch K1 10, K2 6 and K4 6
   times;
9. Stage 1 at the canonical size: ``GanTrainer`` over the generator,
   ``PatchDiscriminator(3, 32)`` and ``PerceptualLoss(0.25)`` in bf16,
   batch 1, ``adv_on=1``, 1 warm-up step then 3 steps; each must launch
   K1 10 times in the generator's forward (read when it returns) and 10
   times for the input gradients after it, and K3 10 times, all 10 on
   its bf16 tensor-core variant;
10. GroupNorm + act (K5): K5a (statistics) and K5b (apply + act)
   against their plain versions at the generator's three GroupNorm
   widths, batch 4, f32 and bf16, every act, and two ragged shapes;
   ``GroupNormActFn``'s gradients against autograd of ``_reference``;
   each kernel timed in bf16 beside its bound, its plain version and the
   library call; then the path: ``group_norm_act`` forward and backward
   once at each width, exactly one K5a and one K5b launch per call;
11. a Stage-2 step with a NaN input, then a finite one, on the card:
   the skipped step moves nothing but Adam's count, and the next one is
   Adam's update at count 2, as in the JAX trainer; then Stage 1, with
   ``d_fresh_recon`` off and on: a finite step, a NaN step that moves no
   parameter and no moment of G or D but advances both Adam counts, and
   a finite step;
12. the entry points a user runs, through their ``main``, at full width
   over synthetic trees in a temporary directory (configs from
   ``configs/*.yaml``, 1 epoch, bf16): ``main_gan_vit`` (batch 1, 2 steps,
   remat, auto-resume) -> ``classify_mamba`` on its ``model.npz`` (batch
   2, 2 steps) -> ``test_mamba`` on the saved npz; the weights each hands
   on must be bitwise the giver's, ``test_mamba``'s printed metrics those
   of ``ClassifyTrainer.eval_step`` over the same batches, the newest
   auto-resume snapshot Stage 1's last state (both Adams too), and K1-K4
   must each launch; each CLI's wall, its step times, the loader's wait
   per batch and the codec that decoded each volume are logged.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  K1's ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` are per forward of the main path (its 10
conv calls at batch 4), its ``dz`` entry per Stage-1 step; K2's per
forward (its 6 scan calls at batch 4) and K4's per Stage-2 step (6 calls
at batch 1), on a Mamba layer's bf16 operands as the main path gives
them, ``ms`` being their device time alone and ``call_ms`` their time
through the wrapper, with the other batch's per-call times beside them
and ``bound_ms`` from the bf16 bytes; K3's per
Stage-1 step (10 calls); K5a's and K5b's per pass over the three widths
(one call each).  ``launches`` counts each kernel over the run of the
path it serves: K1 and K2 the 3 requests of phase 5, K4 the 3 steps of
phase 8, K3 (and K1's ``dz_launches``) the 3 steps of phase 9, K5a and
K5b the 3 calls of phase 10.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12        # H100 SXM dense tensor-core FLOP/s
PEAK_F32 = 67e12          # H100 SXM FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# bench.py's canonical configuration (batch 4, bf16)
CANONICAL = dict(categories=(6,) * 8, num_continuous=40, dim=512, depth=6,
                 heads=8, seq_length=4, f_maps=(64, 128, 256))
IMG = (160, 160, 96)
BATCH = 4
# the generator's 3x3x3 convs per forward: (spatial, channels, count)
CONV_LEVELS = (((160, 160, 96), 64, 4), ((80, 80, 48), 128, 4),
               ((40, 40, 24), 256, 2))
SCAN_SHAPE = (BATCH, 1 + 8 + 40 + 4, 1024, 16)   # (B, L, ED, N)
SCAN_CALLS = 6
# training runs at batch 1 (bench.py:205); the Stage-1 generator's 10
# convs run a backward each (K1 as dz, K3 as dw), the 6 Mamba layers K4
TRAIN_BATCH = 1
GRAD_NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")
# dependent latency of one f32 FMA or multiply on Hopper, in cycles (the
# serial floor of a scan's walk, logged beside its times)
FMA_LATENCY_CYCLES = 4
# K3's design in csrc/conv3d_dw.cu, and v1's times (one tap per block,
# f32 FMAs on the CUDA cores; per call by channel width and per Stage-1
# step, H100 80GB HBM3 at 700 W, from PERF.md section 6), logged for
# comparison and kept out of the kernels line
K3_VERSION = ("v2: bf16 mma.sync m16n8k16 over a TMA-staged, double-buffered "
              "x slab serving the 9 taps of one dx, GN affine applied in "
              "shared memory")
K3_V1_MS = {64: 20.96, 128: 10.38, 256: 5.14}
K3_V1_STEP_MS = 135.63
# K1's design in csrc/conv3d.cu (its bf16 launch from conv_plan), and
# v5's times (per canonical request and per Stage-1 step's input
# gradients, H100 80GB HBM3 at 700 W, from PERF.md section 6), logged for
# comparison and kept out of the kernels line
K1_VERSION = ("v6: bf16 mma.sync m16n8k16 on an 8x8x8 brick over a 2-stage "
              "TMA ring (halo and weights per 16-channel chunk, mbarriers), "
              "GN affine applied in shared memory")
K1_V5_REQUEST_MS = 60.6
K1_V5_DZ_STEP_MS = 13.97
# group_norm_act (K5) runs at the generator's GroupNorm widths (the conv
# levels above), 8 groups
GN_GROUPS = 8
GN_ACTS = ("none", "elu", "relu", "leaky_relu")


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
    events, 3 replays averaged.  The host work of the wrapper is not in
    it; the inputs stay in the L2 cache between calls."""
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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def serial_floor_ms(dependent_ops: int) -> float:
    """What one sequential walk cannot beat: its chain of dependent f32
    FMAs or multiplies, FMA_LATENCY_CYCLES each, at the card's highest SM
    clock.  Not a roofline."""
    return dependent_ops * FMA_LATENCY_CYCLES / max_sm_clock_hz() * 1e3


def rel_err(got, want, floor: float = 1.0) -> tuple[float, float]:
    """max |got - want|, and that over max(floor, max |want|)."""
    want = want.detach().to(got.device).float()
    diff = (got.detach().float() - want).abs().max().item()
    return diff, diff / max(floor, want.abs().max().item())


def conv_inputs(gen, shape, C, F, dtype, residual):
    dev = "cuda"
    x = torch.randn(*shape, C, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, 3, C, F, generator=gen, device=dev)
         * (27 * C) ** -0.5).to(dtype)
    a = torch.rand(shape[0], C, generator=gen, device=dev) + 0.5
    s = torch.randn(shape[0], C, generator=gen, device=dev)
    res = torch.randn(*shape, F, generator=gen, device=dev).to(dtype) \
        if residual else None
    return x, w, None, a, s, res


def conv_bound_ms(B, spatial, C, F, residual) -> tuple[float, str]:
    vox = B * spatial[0] * spatial[1] * spatial[2]
    flops = 2 * vox * 27 * C * F
    nbytes = 2 * (vox * C + 27 * C * F + vox * F * (2 if residual else 1)) \
        + 2 * B * C * 4
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_k1(gen) -> dict:
    """K1 against its plain version: each conv level at batch 1 in f32 and
    bf16, a ragged shape, then the main path's own shapes (batch 4, bf16:
    GN+conv+relu and GN+conv+residual+relu), which are also timed."""
    from gfe_mamba_torch.ops.cuda import conv3d as k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    variants = (("relu", False, "none"), ("none", True, "relu"))
    worst_bf16 = 0.0
    cases = [((1,) + sp, C, C) for sp, C, _ in CONV_LEVELS]
    # ragged: C, F % 16 != 0; X, Y not multiples of the brick, Z = 24
    cases += [((2, 9, 13, 21), 24, 40), ((1, 9, 13, 24), 24, 40),
              ((3, 11, 6, 24), 128, 64)]
    for shape, C, F in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for act, with_res, post in variants:
                x, w, b, a, s, res = conv_inputs(gen, shape, C, F, dtype,
                                                 with_res)
                got = k1.conv3x3x3_cuda(x, w, b, a, s, res, act, post)
                want = k1.conv3x3x3_plain(x, w, b, a, s, res, act, post)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                log(f"K1 check {shape}x{C}->{F} {str(dtype)[6:]} act={act} "
                    f"residual={with_res} post={post}: max_abs_err={err:.3e}"
                    f" rel={rel:.3e} (tol {tol[dtype]})")
                if not rel <= tol[dtype]:
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version: rel {rel} > {tol[dtype]}")
                del x, w, a, s, res, got, want
    torch.cuda.empty_cache()

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    per_shape = []
    for spatial, C, count in CONV_LEVELS:
        log(f"K1 plan {[BATCH, *spatial, C]}: "
            f"{k1.conv_plan(BATCH, *spatial, C, C)}")
        for act, with_res, post in variants:
            x, w, b, a, s, res = conv_inputs(gen, (BATCH,) + spatial, C, C,
                                             torch.bfloat16, with_res)
            got = k1.conv3x3x3_cuda(x, w, b, a, s, res, act, post)
            want = k1.conv3x3x3_plain(x, w, b, a, s, res, act, post)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            log(f"K1 check {[BATCH, *spatial, C]} bfloat16 act={act} "
                f"residual={with_res} post={post}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol[torch.bfloat16]})")
            if not rel <= tol[torch.bfloat16]:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"rel {rel} > {tol[torch.bfloat16]}")
            worst_bf16 = max(worst_bf16, err)
            del got, want
            ms = time_ms(lambda: k1.conv3x3x3_cuda(x, w, b, a, s, res, act,
                                                   post))
            plain = time_ms(lambda: k1.conv3x3x3_plain(x, w, b, a, s, res,
                                                       act, post))
            xc = x.permute(0, 4, 1, 2, 3)               # channels_last_3d
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            lib = time_ms(lambda: torch.nn.functional.conv3d(xc, wc,
                                                             padding=1))
            bound, by = conv_bound_ms(BATCH, spatial, C, C, with_res)
            calls = count // 2          # conv2 (act) and conv3 (residual)
            per_shape.append(dict(shape=[BATCH, *spatial, C], act=act,
                                  residual=with_res, calls=calls, ms=ms,
                                  plain_ms=plain, library_ms=lib,
                                  bound_ms=bound, bound_by=by))
            log(f"K1 time {[BATCH, *spatial, C]} act={act} "
                f"residual={with_res}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, cuDNN conv {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by}); {calls} per forward")
            totals["ms"] += calls * ms
            totals["plain_ms"] += calls * plain
            totals["bound_ms"] += calls * bound
            totals["library_ms"] += calls * lib
            del x, w, a, s, res, xc, wc
    torch.cuda.empty_cache()
    log(f"K1 per forward: kernel {totals['ms']:.3f} ms, cuDNN conv "
        f"{totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms, "
        f"v5 {K1_V5_REQUEST_MS} ms")
    return dict(name="K1 fused GN-apply + 3x3x3 conv + epilogue",
                version=K1_VERSION,
                route="cuda", source="gfe_mamba_torch/csrc/conv3d.cu",
                replaces="gfe_mamba_tpu/ops/pallas/conv3d.py:82",
                max_abs_err=worst_bf16,
                bound_by=max(per_shape, key=lambda r: r["bound_ms"])[
                    "bound_by"],
                per="forward: 10 calls at batch 4, bf16",
                per_shape=per_shape, **totals)


def scan_inputs(gen, bsz, L, ED, N):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    return [r(bsz, L, ED), r(bsz, L, ED, scale=0.5), -r(ED, N).abs(),
            r(bsz, L, N), r(bsz, L, N), r(ED), r(bsz, L, ED),
            r(ED, scale=0.1)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def mamba_operands(bsz, seed):
    """The scan's operands as a canonical Mamba layer (d_model = the
    classifier's dim, ED 1024, N 16) hands them over in bf16 on the card
    (``MambaBlock.scan_operands``): x channel-major from the depthwise
    conv, z a ``chunk`` view, B and C ``split`` views, D and delta_bias
    bf16, A f32."""
    from gfe_mamba_torch.testing import mamba_scan_operands

    _, L, ED, N = SCAN_SHAPE
    args = mamba_scan_operands(bsz, L, CANONICAL["dim"], torch.bfloat16,
                               "cuda", d_state=N, seed=seed)
    assert args[0].shape == (bsz, L, ED) and args[2].shape == (ED, N)
    return args


def scan_bound_ms(args, y) -> tuple[float, str]:
    """K2's bound on these operands: every input read once and y written
    once, in their own dtypes; ~6N + 10 f32 operations per (b, t, e)."""
    bsz, L, ED = args[0].shape
    N = args[2].shape[1]
    ops = bsz * L * ED * (6 * N + 10)
    t_ops, t_bytes = ops / PEAK_F32, nbytes(*args, y) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_k2(gen) -> dict:
    """K2 against its plain version in f32 (gate/bias/softplus on and off;
    batch 4 and 1; ragged ED) and on a canonical Mamba layer's bf16
    operands (views, channel-major x) at batch 4 and 1; then its device
    time alone (a CUDA graph) and through the wrapper, beside its bound
    and the serial floor of its walk: on the bf16 views for the kernels
    line (batch 4, the main path's, and 1, the Stage-2 step's), and on
    contiguous f32 operands for the log."""
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    from gfe_mamba_torch.testing import bf16_ulps

    bsz, L, ED, N = SCAN_SHAPE
    for b, ed in ((bsz, ED), (TRAIN_BATCH, ED), (bsz, 1000),
                  (TRAIN_BATCH, 1001)):
        x, d, A, B, C, D, z, bias = scan_inputs(gen, b, L, ed, N)
        for gate, with_bias, softplus in ((True, True, True),
                                          (False, False, True),
                                          (True, False, False)):
            # without softplus the step must be positive, as a real dt is;
            # a negative one makes exp(d*A) grow over L
            args = (x, d if softplus else d.abs(), A, B, C, D,
                    z if gate else None, bias if with_bias else None,
                    softplus)
            got = k2.selective_scan_cuda(*args)
            want = k2.selective_scan_plain(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            log(f"K2 check ({b},{L},{ed},N={N}) f32 gate={gate} "
                f"bias={with_bias} softplus={softplus}: max_abs_err="
                f"{err:.3e} rel={rel:.3e} (tol 1e-5)")
            if not rel <= 1e-5:
                raise AssertionError(f"K2 disagrees with its plain version: "
                                     f"rel {rel} > 1e-5")
    views, worst = {}, {}
    for b in (bsz, TRAIN_BATCH):
        # y in bf16 against the plain f32 result on the same operands,
        # rounded once
        views[b] = args = mamba_operands(b, seed=b)
        got = k2.selective_scan_cuda(*args, delta_softplus=True)
        want = k2.selective_scan_plain(*[t.float() for t in args],
                                       delta_softplus=True)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, want)
        worst[b] = (rel_err(got, want)[0], ulps)
        log(f"K2 check ({b},{L},{ED},N={N}) bf16 Mamba-layer operands "
            f"(channel-major x, z/B/C views): y {ulps:.3f} bf16 ulp of the "
            f"plain f32 result rounded (tol 1 ulp), max_abs_err "
            f"{worst[b][0]:.3e}")
        if not (ulps <= 1.0 and got.dtype == torch.bfloat16):
            raise AssertionError("K2 with bf16 operands disagrees with its "
                                 "plain version")
    floor = serial_floor_ms(L)
    times = {}
    for b in (bsz, TRAIN_BATCH):
        for kind, args in (("bf16 views", views[b]),
                           ("f32", scan_inputs(gen, b, L, ED, N))):
            y = k2.selective_scan_cuda(*args, delta_softplus=True)
            dev = graph_ms(lambda: k2.selective_scan_cuda(
                *args, delta_softplus=True))
            call = time_ms(lambda: k2.selective_scan_cuda(
                *args, delta_softplus=True), reps=50)
            bound = scan_bound_ms(args, y)[0]
            log(f"K2 time ({b},{L},{ED},N={N}) {kind}: device {dev:.4f} ms "
                f"per call (CUDA graph of 50), through the wrapper "
                f"{call:.4f} ms, bound {bound:.5f} ms, serial floor "
                f"{floor:.5f} ms")
            times[b, kind] = dev, call
    args = views[bsz]
    plain = time_ms(lambda: k2.selective_scan_plain(
        *[t.float() for t in args], delta_softplus=True))
    bound, bound_by = scan_bound_ms(
        args, k2.selective_scan_cuda(*args, delta_softplus=True))
    log(f"K2 at ({bsz},{L},{ED},N={N}) bf16 views: plain {plain:.4f} ms "
        f"per call (f32 casts and the loop); {SCAN_CALLS} calls per forward")
    dev4, call4 = times[bsz, "bf16 views"]
    dev1, call1 = times[TRAIN_BATCH, "bf16 views"]
    return dict(name="K2 selective-scan forward", route="cuda",
                source="gfe_mamba_torch/csrc/selective_scan.cu",
                replaces="gfe_mamba_tpu/ops/pallas/selective_scan.py:42",
                max_abs_err=worst[bsz][0], bf16_ulps=worst[bsz][1],
                ms=SCAN_CALLS * dev4, call_ms=SCAN_CALLS * call4,
                plain_ms=SCAN_CALLS * plain, bound_ms=SCAN_CALLS * bound,
                bound_by=bound_by, batch1_device_ms_per_call=dev1,
                batch1_call_ms_per_call=call1, library_ms=None,
                per="forward: 6 calls of (4,53,1024,N=16) on a Mamba "
                    "layer's bf16 operands (channel-major x, z/B/C views); "
                    "ms is device time (CUDA graph), call_ms through the "
                    "wrapper")


def check_pipeline_parity():
    """Full widths, reduced volume, f32: CPU (plain) vs card (kernels)."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = (64, 64, 32)
    cpu = build_gfe_mamba(img_size=img, vit_patch_size=16, device="cpu",
                          seed=1, **CANONICAL)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(11)
    mri = torch.randn(2, *img, 1, generator=gen)
    x_cat = torch.randint(0, 6, (2, 8), generator=gen)
    x_num = torch.randn(2, 40, generator=gen)
    with torch.inference_mode():
        logits_c, pet_c = cpu(mri, x_cat, x_num, return_pet=True)
        logits_g, pet_g = gpu(mri.cuda(), x_cat.cuda(), x_num.cuda(),
                              return_pet=True)
        torch.cuda.synchronize()
    for name, got, want in (("logits", logits_g, logits_c),
                            ("pet", pet_g, pet_c)):
        err, rel = rel_err(got.cpu(), want)
        log(f"pipeline parity {img} f32 {name}: max_abs_err={err:.3e} "
            f"rel={rel:.3e} (tol 1e-3)")
        if not (torch.isfinite(got).all() and rel <= 1e-3):
            raise AssertionError(f"pipeline {name}: card and CPU disagree")
    del gpu
    torch.cuda.empty_cache()


def serve_canonical(card: str) -> tuple[int, int]:
    """The main path: 3 requests of batch 4 at the canonical size, bf16."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    t0 = time.perf_counter()
    model = build_gfe_mamba(img_size=IMG, device="cuda",
                            dtype=torch.bfloat16, seed=0, **CANONICAL)
    log(f"canonical model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")
    gen = torch.Generator(device="cuda")

    def request(seed):
        gen.manual_seed(seed)
        mri = torch.randn(BATCH, *IMG, 1, generator=gen,
                          device="cuda").to(torch.bfloat16)
        x_cat = torch.randint(0, 6, (BATCH, 8), generator=gen, device="cuda")
        x_num = torch.randn(BATCH, 40, generator=gen,
                            device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            return model(mri, x_cat, x_num, return_pet=True)

    request(100)                                  # warm-up
    torch.cuda.synchronize()
    k1.launches = 0
    k2.launches = 0
    for i in range(3):
        before = (k1.launches, k2.launches)
        t = time.perf_counter()
        logits, pet = request(i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        per = (k1.launches - before[0], k2.launches - before[1])
        ok = (logits.shape == (BATCH, 1) and pet.shape == (BATCH, *IMG, 1)
              and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(pet).all()))
        log(f"request {i}: {dt * 1e3:.1f} ms, {BATCH / dt:.2f} volumes/s "
            f"[{card}]; K1 launches {per[0]}, K2 launches {per[1]}; "
            f"logits {logits.float().flatten().tolist()}")
        if not ok:
            raise AssertionError("canonical forward: bad or non-finite output")
        if per != (10, 6):
            raise AssertionError(f"expected 10 K1 and 6 K2 launches per "
                                 f"forward, got {per}")
    return k1.launches, k2.launches


def scan_bwd_bound_ms(args, g, grads) -> tuple[float, str]:
    """K4's bound on these operands: every input (and g) read once and
    every gradient written once, in their own dtypes; ~20 operations per
    state element and step over both passes plus ~30 per step."""
    bsz, L, ED = args[0].shape
    N = args[2].shape[1]
    ops = bsz * L * ED * (20 * N + 30)
    t_ops = ops / PEAK_F32
    t_bytes = nbytes(*args, g, *grads) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_k4(gen) -> dict:
    """K4 against its plain version in f32 (every gradient; gate/bias/
    softplus on and off; batch 1 and 4; ragged ED) and on a canonical
    Mamba layer's bf16 operands (views, channel-major x) at batch 1 and 4;
    a second call on those bitwise equal to the first; then its device
    time alone (a CUDA graph) and through the wrapper, beside its bound
    and the serial floor of its walks: on the bf16 views for the kernels
    line (batch 1, the Stage-2 step's, and 4), and on contiguous f32
    operands for the log."""
    from gfe_mamba_torch.ops.cuda import selective_scan as ks
    from gfe_mamba_torch.testing import bf16_ulps

    _, L, ED, N = SCAN_SHAPE
    for bsz, ed in ((TRAIN_BATCH, ED), (BATCH, ED), (TRAIN_BATCH, 1000),
                    (BATCH, 1001)):
        x, d, A, B, C, D, z, bias = scan_inputs(gen, bsz, L, ed, N)
        g = torch.randn(bsz, L, ed, generator=gen, device="cuda")
        for gate, with_bias, softplus in ((True, True, True),
                                          (False, False, True),
                                          (True, False, False)):
            args = (x, d if softplus else d.abs(), A, B, C, D,
                    z if gate else None, bias if with_bias else None, g,
                    softplus)
            got = ks.selective_scan_bwd_cuda(*args)
            want = ks.selective_scan_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, b) for n, a, b in zip(GRAD_NAMES, got, want)
                    if b is not None}
            err = max(e for e, _ in errs.values())
            rel = max(r for _, r in errs.values())
            log(f"K4 check ({bsz},{L},{ed},N={N}) f32 gate={gate} "
                f"bias={with_bias} softplus={softplus}: max_abs_err="
                f"{err:.3e} rel={rel:.3e} over {len(errs)} gradients "
                f"(tol 1e-4)")
            if not rel <= 1e-4:
                raise AssertionError(f"K4 disagrees with its plain version: "
                                     f"{errs}")
    views, worst = {}, {}
    for bsz in (TRAIN_BATCH, BATCH):
        # dx, ddelta, dz in bf16 against the plain f32 result on the same
        # operands, rounded once; dA, dB, dC, dD, dbias in f32 at 1e-4
        args = mamba_operands(bsz, seed=10 + bsz)
        g = torch.randn(bsz, L, ED, generator=gen,
                        device="cuda").bfloat16()
        views[bsz] = args, g
        got = ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
        want = ks.selective_scan_bwd_plain(*[t.float() for t in args],
                                           g.float(), delta_softplus=True)
        torch.cuda.synchronize()
        ulps = max(bf16_ulps(got[i], want[i]) for i in (0, 1, 6))
        rel = max(rel_err(got[i], want[i])[1] for i in (2, 3, 4, 5, 7))
        worst[bsz] = (max(rel_err(a, b)[0] for a, b in zip(got, want)),
                      ulps)
        log(f"K4 check ({bsz},{L},{ED},N={N}) bf16 Mamba-layer operands "
            f"(channel-major x, z/B/C views): dx, ddelta, dz {ulps:.3f} "
            f"bf16 ulp of the plain f32 result rounded (tol 1 ulp); dA, dB, "
            f"dC, dD, dbias rel={rel:.3e} (tol 1e-4); max_abs_err "
            f"{worst[bsz][0]:.3e}")
        if not (ulps <= 1.0 and rel <= 1e-4
                and all(got[i].dtype == torch.bfloat16 for i in (0, 1, 6))):
            raise AssertionError("K4 with bf16 operands disagrees with its "
                                 "plain version")
    args, g = views[TRAIN_BATCH]
    first = ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    second = ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("K4: two calls on the same inputs differ")
    log("K4 determinism: a second call on the bf16 views is bitwise equal "
        "to the first")
    floor = serial_floor_ms(3 * L)
    times = {}
    for bsz in (TRAIN_BATCH, BATCH):
        f32 = (scan_inputs(gen, bsz, L, ED, N),
               torch.randn(bsz, L, ED, generator=gen, device="cuda"))
        for kind, (args, g) in (("bf16 views", views[bsz]), ("f32", f32)):
            grads = ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
            dev = graph_ms(lambda: ks.selective_scan_bwd_cuda(
                *args, g, delta_softplus=True))
            call = time_ms(lambda: ks.selective_scan_bwd_cuda(
                *args, g, delta_softplus=True), reps=50)
            bound = scan_bwd_bound_ms(args, g, grads)[0]
            log(f"K4 time ({bsz},{L},{ED},N={N}) {kind}: device {dev:.4f} "
                f"ms per call (CUDA graph of 50), through the wrapper "
                f"{call:.4f} ms, bound {bound:.5f} ms, serial floor "
                f"{floor:.5f} ms")
            times[bsz, kind] = dev, call
    args, g = views[TRAIN_BATCH]
    plain = time_ms(lambda: ks.selective_scan_bwd_plain(
        *[t.float() for t in args], g.float(), delta_softplus=True))
    bound, bound_by = scan_bwd_bound_ms(
        args, g, ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True))
    log(f"K4 at ({TRAIN_BATCH},{L},{ED},N={N}) bf16 views: plain "
        f"{plain:.4f} ms per call (f32 casts and the loops); {SCAN_CALLS} "
        f"calls per Stage-2 step")
    dev1, call1 = times[TRAIN_BATCH, "bf16 views"]
    dev4, call4 = times[BATCH, "bf16 views"]
    return dict(name="K4 selective-scan backward", route="cuda",
                source="gfe_mamba_torch/csrc/selective_scan_bwd.cu",
                replaces="gfe_mamba_tpu/ops/pallas/selective_scan.py:126",
                max_abs_err=worst[TRAIN_BATCH][0],
                bf16_ulps=worst[TRAIN_BATCH][1],
                ms=SCAN_CALLS * dev1, call_ms=SCAN_CALLS * call1,
                plain_ms=SCAN_CALLS * plain, bound_ms=SCAN_CALLS * bound,
                bound_by=bound_by, batch4_device_ms_per_call=dev4,
                batch4_call_ms_per_call=call4, library_ms=None,
                per="Stage-2 step: 6 calls of (1,53,1024,N=16) on a Mamba "
                    "layer's bf16 operands (channel-major x, z/B/C views); "
                    "ms is device time (CUDA graph), call_ms through the "
                    "wrapper")


def cudnn_conv_grad(x, w, g, which):
    """cuDNN's wgrad (``which="w"``) or dgrad (``"x"``) of the SAME 3x3x3
    conv on channels_last_3d tensors: the library yardstick, never called
    by the port."""
    wt = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    mask = [which == "x", which == "w", False]
    return torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), wt, None,
        [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, mask)


def check_k3(gen) -> dict:
    """K3 against its plain version at the three generator levels (batch
    1) and ragged shapes (bricks ragged in every axis, C != F over two
    channel tiles), f32 and bf16, with and without the GN affine; a bf16
    call must launch the tensor-core variant and an f32 call the CUDA-core
    one, and a second bf16 call must return the same bits.  Then timed at
    the Stage-1 shapes (bf16, affine) beside cuDNN's wgrad of the same
    (already affine-applied) input, the bound and v1's time."""
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    cases = [((TRAIN_BATCH,) + sp, C, C) for sp, C, _ in CONV_LEVELS]
    cases += [((2, 9, 13, 21), 24, 40), ((1, 6, 7, 20), 128, 64)]
    worst = 0.0
    for shape, C, F in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for affine in (True, False):
                x, _, _, a, s, g1 = conv_inputs(gen, shape, C, F, dtype,
                                                True)
                if not affine:
                    a = s = None
                before = (kc.dw_mma_launches, kc.dw_fma_launches)
                got = kc.conv3x3x3_dw_cuda(x, g1, a, s)
                want = kc.conv3x3x3_dw_plain(x, g1, a, s)
                torch.cuda.synchronize()
                mma = dtype == torch.bfloat16
                moved = (kc.dw_mma_launches - before[0],
                         kc.dw_fma_launches - before[1])
                if moved != ((1, 0) if mma else (0, 1)):
                    raise AssertionError(f"K3 {dtype} call launched "
                                         f"(tensor-core, CUDA-core) {moved}")
                err, rel = rel_err(got, want)
                same = ""
                if mma:
                    again = kc.conv3x3x3_dw_cuda(x, g1, a, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError("two bf16 K3 calls on the same "
                                             "inputs differ")
                    same = ", a second call bitwise equal"
                    del again
                log(f"K3 check {shape}x{C}->{F} {str(dtype)[6:]} "
                    f"affine={affine} ({'tensor' if mma else 'CUDA'} "
                    f"cores): max_abs_err={err:.3e} rel={rel:.3e} "
                    f"(tol 1e-4){same}")
                if not rel <= 1e-4:
                    raise AssertionError(f"K3 disagrees with its plain "
                                         f"version: rel {rel} > 1e-4")
                if mma and affine and shape[0] == 1:
                    worst = max(worst, err)
                del x, a, s, g1, got, want
    torch.cuda.empty_cache()

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    per_shape = []
    for spatial, C, count in CONV_LEVELS:
        x, _, _, a, s, g1 = conv_inputs(gen, (TRAIN_BATCH,) + spatial, C, C,
                                        torch.bfloat16, True)
        w = torch.empty(3, 3, 3, C, C, dtype=torch.bfloat16, device="cuda")
        zhat = kc.affine_in_dtype(x, a, s)
        ms = time_ms(lambda: kc.conv3x3x3_dw_cuda(x, g1, a, s))
        bare = time_ms(lambda: kc.conv3x3x3_dw_cuda(x, g1))
        plain = time_ms(lambda: kc.conv3x3x3_dw_plain(x, g1, a, s), reps=2)
        lib = time_ms(lambda: cudnn_conv_grad(zhat, w, g1, "w"))
        vox = TRAIN_BATCH * spatial[0] * spatial[1] * spatial[2]
        t_ops = 2 * vox * 27 * C * C / PEAK_BF16
        t_bytes = (2 * 2 * vox * C + 4 * 27 * C * C
                   + 2 * 4 * TRAIN_BATCH * C) / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        peak_share = t_ops * 1e3 / ms
        per_shape.append(dict(shape=[TRAIN_BATCH, *spatial, C], calls=count,
                              ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bound, bound_by=by,
                              bf16_peak_share=peak_share,
                              no_affine_ms=bare))
        log(f"K3 time {[TRAIN_BATCH, *spatial, C]} bf16: kernel {ms:.4f} ms "
            f"({peak_share:.1%} of the bf16 peak; {bare:.4f} ms without the "
            f"affine), plain {plain:.4f} ms, cuDNN wgrad {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), v1 {K3_V1_MS[C]} ms; {count} per "
            f"Stage-1 step")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                       ("library_ms", lib)):
            totals[key] += count * v
        del x, a, s, g1, zhat, w
    torch.cuda.empty_cache()
    log(f"K3 per Stage-1 step: kernel {totals['ms']:.3f} ms, cuDNN wgrad "
        f"{totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms, "
        f"v1 {K3_V1_STEP_MS} ms")
    return dict(name="K3 conv weight gradient", version=K3_VERSION,
                route="cuda", source="gfe_mamba_torch/csrc/conv3d_dw.cu",
                replaces="gfe_mamba_tpu/ops/pallas/conv3d.py:516",
                max_abs_err=worst, bound_by="operations",
                per="Stage-1 step: 10 calls at batch 1, bf16",
                per_shape=per_shape, **totals)


def check_k1_dz(gen) -> dict:
    """K1 as the conv's input gradient: the cotangent through the flipped,
    transposed weights, no GN, bf16, at the Stage-1 shapes; against its
    plain version and timed beside cuDNN's dgrad."""
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    worst = 0.0
    per_shape = []
    for spatial, C, count in CONV_LEVELS:
        g1, w, _, _, _, _ = conv_inputs(gen, (TRAIN_BATCH,) + spatial, C, C,
                                        torch.bfloat16, False)
        wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        got = kc.conv3x3x3_cuda(g1, wf)
        want = kc.conv3x3x3_plain(g1, wf)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        log(f"K1-dz check {[TRAIN_BATCH, *spatial, C]} bf16: max_abs_err="
            f"{err:.3e} rel={rel:.3e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"K1 (dz) disagrees with its plain version: "
                                 f"rel {rel}")
        worst = max(worst, err)
        ms = time_ms(lambda: kc.conv3x3x3_cuda(g1, wf))
        plain = time_ms(lambda: kc.conv3x3x3_plain(g1, wf))
        lib = time_ms(lambda: cudnn_conv_grad(g1, w, g1, "x"))
        bound, by = conv_bound_ms(TRAIN_BATCH, spatial, C, C, False)
        per_shape.append(dict(shape=[TRAIN_BATCH, *spatial, C], calls=count,
                              ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bound, bound_by=by))
        log(f"K1-dz time {[TRAIN_BATCH, *spatial, C]} bf16: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, cuDNN dgrad {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); {count} per Stage-1 step")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                       ("library_ms", lib)):
            totals[key] += count * v
        del g1, w, wf, got, want
    torch.cuda.empty_cache()
    log(f"K1-dz per Stage-1 step: kernel {totals['ms']:.3f} ms, cuDNN dgrad "
        f"{totals['library_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms, "
        f"v5 {K1_V5_DZ_STEP_MS} ms")
    return dict(per="Stage-1 step: 10 calls at batch 1, bf16",
                max_abs_err=worst, bound_by="operations",
                per_shape=per_shape, **totals)


def check_conv_function(gen):
    """The conv autograd Function on the card (K1 forward, K1 dz, K3 dw)
    against torch.autograd through the plain forward on the card, f32, at
    the 128-channel level: both ResNetBlock shapes (GN+conv+act and
    GN+conv+residual+post_act).  The activation is elu, whose derivative
    is continuous at 0: with relu, the ~40 of 4.9e7 outputs whose
    pre-activation lies within f32 rounding of 0 take opposite masks in
    the two forwards, which moves dx by up to 1.5% of its max (a fault of
    no kernel; the relu backward is held against JAX on the CPU)."""
    from gfe_mamba_torch.ops import conv3d as ops_conv
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    spatial, C, _ = CONV_LEVELS[1]
    names = ("dx", "dw", "dbias", "da", "ds", "dres")
    for act, with_res, post in (("elu", False, "none"),
                                ("none", True, "elu")):
        x, w, _, a, s, res = conv_inputs(gen, (TRAIN_BATCH,) + spatial, C, C,
                                         torch.float32, with_res)
        g = torch.randn(TRAIN_BATCH, *spatial, C, generator=gen,
                        device="cuda")
        grads = []
        for fn in (ops_conv.conv3x3x3, kc.conv3x3x3_plain):
            ins = [None if t is None else t.clone().requires_grad_()
                   for t in (x, w, None, a, s, res)]
            fn(*ins, act, post).backward(g)
            grads.append([None if t is None else t.grad for t in ins])
        torch.cuda.synchronize()
        for name, got, want in zip(names, *grads):
            if want is None:
                continue
            err, rel = rel_err(got, want)
            log(f"conv Function check {[TRAIN_BATCH, *spatial, C]} f32 "
                f"act={act} residual={with_res}: {name} max_abs_err="
                f"{err:.3e} rel={rel:.3e} (tol 1e-3)")
            if not rel <= 1e-3:
                raise AssertionError(f"conv Function {name} disagrees with "
                                     f"autograd of the plain forward")
        del x, w, a, s, res, g, grads
    torch.cuda.empty_cache()


def grad_errors(opt_pairs, floor=1e-6) -> dict:
    """Per-tensor distance between the Adam first moments (0.1 x the
    clipped gradient after one step) of two runs, ``{name: (max-rel,
    norm-rel)}``: max |d| over the tensor's largest entry, and |d| over
    the tensor's norm.  A tensor under ``floor`` per entry (1e-5 of a
    clipped gradient of norm <= 1) is measured against the floor instead:
    such a gradient is zero in exact arithmetic (the key bias of an
    attention, which the softmax cancels) and holds rounding noise only."""
    out = {}
    for player, opt_a, params_a, opt_b, params_b in opt_pairs:
        for (name, pa), pb in zip(params_a.items(), params_b.values()):
            if pa not in opt_a.state:
                continue
            got = opt_b.state[pb]["exp_avg"].detach().float()
            want = opt_a.state[pa]["exp_avg"].detach().to(got.device).float()
            diff = got - want
            max_rel = diff.abs().max().item() / max(
                floor, want.abs().max().item())
            norm_rel = diff.norm().item() / max(
                want.norm().item(), floor * want.numel() ** 0.5)
            out[f"{player}:{name}"] = (max_rel, norm_rel)
    return out


def worst(errors: dict, which: int) -> tuple[float, str]:
    return max((e[which], name) for name, e in errors.items())


def check_losses(tag, logs_c, logs_g, tol=1e-3) -> None:
    """The logged losses of a CPU step and a card step, within ``tol``."""
    for key, want in logs_c.items():
        got = logs_g[key]
        rel = abs(got - want) / max(1.0, abs(want))
        log(f"{tag} parity {key}: cpu {want:.7g} card {got:.7g} "
            f"rel={rel:.3e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"{tag}: {key} differs on the card")


def report_grads(tag, errors: dict, top: int = 1) -> tuple[float, float]:
    """Logs the ``top`` worst tensors by either measure; returns the
    worst rel-to-max and rel-to-norm."""
    for which, measure in ((0, "rel-to-max"), (1, "rel-to-norm")):
        ranked = sorted(((e[which], e[1 - which], n)
                         for n, e in errors.items()), reverse=True)[:top]
        log(f"{tag}: {len(errors)} tensors, worst {measure} " + ", ".join(
            f"{v:.3e} ({n}; other measure {o:.3e})" for v, o, n in ranked))
    return worst(errors, 0)[0], worst(errors, 1)[0]


def check_grads(tag, errors: dict, max_tol: float, norm_tol: float) -> None:
    max_rel, norm_rel = report_grads(f"{tag} parity gradients", errors)
    log(f"{tag} parity gradients: tolerances {max_tol:.3e} rel-to-max, "
        f"{norm_tol:.3e} rel-to-norm")
    if not errors or not max_rel <= max_tol or not norm_rel <= norm_tol:
        raise AssertionError(f"{tag}: gradients differ on the card")


@contextlib.contextmanager
def plain_convs_on_card():
    """The conv Function with K1 and K3 swapped for their plain versions
    on CUDA tensors: a witness run that separates what the kernels do
    from what two f32 forwards on two devices do.  Used by nothing but
    this check."""
    from gfe_mamba_torch.ops import conv3d as ops_conv
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    saved = ops_conv.conv3x3x3_cuda, ops_conv.conv3x3x3_dw_cuda
    ops_conv.conv3x3x3_cuda = kc.conv3x3x3_plain
    ops_conv.conv3x3x3_dw_cuda = kc.conv3x3x3_dw_plain
    try:
        yield
    finally:
        ops_conv.conv3x3x3_cuda, ops_conv.conv3x3x3_dw_cuda = saved


def check_training_parity():
    """Full widths at (64,64,32), f32, dropout off: one Stage-2 and one
    Stage-1 step on the CPU (plain versions) and on the card (kernels)."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import (build_generator,
                                                 build_gfe_mamba)
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = (64, 64, 32)
    reduced = dict(img_size=img, vit_patch_size=16, vit_dropout=0.0,
                   vit_emb_dropout=0.0)
    gen = torch.Generator().manual_seed(21)
    t = time.perf_counter()
    cpu = build_gfe_mamba(device="cpu", seed=1, cross_ff_dropout=0.0,
                          **reduced, **CANONICAL)
    card = copy.deepcopy(cpu)
    batch = (torch.randn(2, *img, 1, generator=gen),
             torch.randint(0, 6, (2, 8), generator=gen),
             torch.randn(2, 40, generator=gen), torch.tensor([1.0, 0.0]))
    trainers = [ClassifyTrainer(m, mixed_precision="none", device=d)
                for m, d in ((cpu, "cpu"), (card, "cuda"))]
    logs = [tr.train_step(*batch) for tr in trainers]
    torch.cuda.synchronize()
    params = [dict(tr.trainable) for tr in trainers]
    check_losses("Stage-2 (64,64,32) f32", logs[0], logs[1])
    check_grads("Stage-2 (64,64,32) f32", grad_errors(
        [("C", trainers[0].optimizer, params[0], trainers[1].optimizer,
          params[1])]), 1e-3, 1e-3)
    log(f"Stage-2 parity done in {time.perf_counter() - t:.1f} s")
    del cpu, card, trainers
    torch.cuda.empty_cache()

    # Stage 1.  (a) The canonical order gcr with the adversary on, at two
    # seeds.  relu in the generator and leaky relu in D have a derivative
    # that jumps at 0; two f32 forwards on two devices put a few
    # pre-activations within rounding of 0 on opposite sides, and each
    # flips one element's gradient.  That moves some parameter gradients
    # by ~1e-2 of their max and of their norm whatever computes the convs
    # (on an H100, kernels and plain convs on the card alike read 1.3e-2
    # to 1.8e-2 against the CPU).  So a witness step runs on the card with
    # the plain convs in place of K1 and K3, and the kernels' step must
    # come within twice the witness's worst error, by either measure (and
    # within 1e-3 where the witness is closer than 5e-4).  (b) The order
    # gce (elu: continuous derivative) with the adversary off, which
    # removes D from G's loss: no mask flips, so G's gradients through
    # K1, K1-as-dz and K3 must agree within 1e-3 by both measures.
    for tag, order, adv_on, seed in (("gcr, adv_on=1", "gcr", 1.0, 2),
                                     ("gcr, adv_on=1", "gcr", 1.0, 12),
                                     ("gce, adv_on=0", "gce", 0.0, 2)):
        tag = f"Stage-1 (64,64,32) f32 {tag}, seed {seed}"
        t = time.perf_counter()
        generator = build_generator(device="cpu", seed=seed,
                                    layer_order=order, **reduced)
        disc = PatchDiscriminator(3, 32)
        disc.reset_parameters(torch.Generator().manual_seed(seed + 1))
        perceptual = PerceptualLoss(0.25, device="cpu")
        witness = adv_on > 0
        models = [(generator, disc, perceptual)] + [
            tuple(copy.deepcopy(m) for m in (generator, disc, perceptual))
            for _ in range(2 if witness else 1)]
        mri = torch.randn(TRAIN_BATCH, *img, 1, generator=gen)
        pet = torch.randn(TRAIN_BATCH, *img, 1, generator=gen)
        trainers = [GanTrainer(*m, mixed_precision="none", device=d)
                    for m, d in zip(models, ("cpu", "cuda", "cuda"))]
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

        check_losses(tag, logs[0], logs[1])
        errors = grad_errors(pairs(trainers[0], trainers[1]))
        if witness:
            check_losses(f"{tag} witness", logs[0], logs[2])
            report_grads(f"{tag} kernels vs CPU", errors, top=5)
            plain_max, plain_norm = report_grads(
                f"{tag} witness: plain convs on the card vs CPU",
                grad_errors(pairs(trainers[0], trainers[2])), top=5)
            report_grads(f"{tag} witness: kernels vs plain convs, both on "
                         f"the card",
                         grad_errors(pairs(trainers[2], trainers[1])))
            check_grads(tag, errors, max(1e-3, 2 * plain_max),
                        max(1e-3, 2 * plain_norm))
        else:
            check_grads(tag, errors, 1e-3, 1e-3)
        log(f"{tag} parity done in {time.perf_counter() - t:.1f} s")
        del models, trainers
        torch.cuda.empty_cache()


def train_stage2_canonical(card: str) -> dict:
    """Stage 2 at the canonical size: 3 bf16 steps of batch 1."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    t0 = time.perf_counter()
    model = build_gfe_mamba(img_size=IMG, device="cuda", seed=0, **CANONICAL)
    trainer = ClassifyTrainer(model, device="cuda")
    log(f"Stage-2 trainer built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")

    def step(seed):
        gen.manual_seed(seed)
        mri = torch.randn(TRAIN_BATCH, *IMG, 1, generator=gen, device="cuda")
        x_cat = torch.randint(0, 6, (TRAIN_BATCH, 8), generator=gen,
                              device="cuda")
        x_num = torch.randn(TRAIN_BATCH, 40, generator=gen, device="cuda")
        labels = torch.randint(0, 2, (TRAIN_BATCH,), generator=gen,
                               device="cuda").float()
        return trainer.train_step(mri, x_cat, x_num, labels)

    step(200)                                     # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = k2.bwd_launches = 0
    times = []
    for i in range(3):
        before = (k1.launches, k2.launches, k2.bwd_launches)
        t = time.perf_counter()
        logs = step(i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        times.append(dt * 1e3)
        per = (k1.launches - before[0], k2.launches - before[1],
               k2.bwd_launches - before[2])
        log(f"Stage-2 step {i}: {dt * 1e3:.1f} ms, {TRAIN_BATCH / dt:.2f} "
            f"volumes/s [{card}]; K1 {per[0]}, K2 {per[1]}, K4 {per[2]} "
            f"launches; {logs}")
        if not math.isfinite(logs["cla_loss"]) or logs["skipped"]:
            raise AssertionError("Stage-2 step: non-finite or skipped")
        if per != (10, 6, 6):
            raise AssertionError(f"expected 10 K1, 6 K2 and 6 K4 launches "
                                 f"per Stage-2 step, got {per}")
    out = dict(k4=k2.bwd_launches, step_ms=times)
    del trainer, model
    torch.cuda.empty_cache()
    return out


def train_stage1_canonical(card: str) -> dict:
    """Stage 1 at the canonical size: 3 bf16 steps of batch 1, adv_on=1."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    t0 = time.perf_counter()
    disc = PatchDiscriminator(3, 32)
    disc.reset_parameters(torch.Generator().manual_seed(1))
    trainer = GanTrainer(build_generator(device="cuda", seed=0), disc,
                         PerceptualLoss(0.25, device="cuda"), device="cuda")
    log(f"Stage-1 trainer built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")

    def volumes(seed):
        gen.manual_seed(seed)
        return [torch.randn(TRAIN_BATCH, *IMG, 1, generator=gen,
                            device="cuda") for _ in range(2)]

    # K1's count when the generator's forward returns splits each step's
    # K1 launches into the forward's and the input gradients' (dz)
    at_forward_end = []
    trainer.generator.register_forward_hook(
        lambda *_: at_forward_end.append(k1.launches))
    trainer.train_step(*volumes(300), 1.0)        # warm-up
    torch.cuda.synchronize()
    k1.launches = k1.dw_launches = 0
    k1.dw_mma_launches = k1.dw_fma_launches = 0
    at_forward_end.clear()
    times, forward, dz = [], 0, 0
    for i in range(3):
        before = (k1.launches, k1.dw_launches, k1.dw_mma_launches)
        t = time.perf_counter()
        logs = trainer.train_step(*volumes(i), 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        times.append(dt * 1e3)
        if len(at_forward_end) != i + 1:
            raise AssertionError(f"{len(at_forward_end) - i} generator "
                                 f"forwards in Stage-1 step {i}")
        per = (at_forward_end[-1] - before[0],
               k1.launches - at_forward_end[-1], k1.dw_launches - before[1],
               k1.dw_mma_launches - before[2])
        forward, dz = forward + per[0], dz + per[1]
        log(f"Stage-1 step {i}: {dt * 1e3:.1f} ms, {TRAIN_BATCH / dt:.2f} "
            f"volumes/s [{card}]; K1 {per[0]} forward + {per[1]} dz, "
            f"K3 {per[2]} launches ({per[3]} on tensor cores); {logs}")
        if not all(math.isfinite(v) for v in logs.values()) \
                or logs["skipped"]:
            raise AssertionError("Stage-1 step: non-finite or skipped")
        if per != (10, 10, 10, 10):
            raise AssertionError(f"expected 10 K1 forward, 10 K1 dz and 10 "
                                 f"K3 launches per Stage-1 step, all 10 on "
                                 f"the tensor-core variant, got {per}")
    if k1.dw_fma_launches:
        raise AssertionError(f"{k1.dw_fma_launches} f32 K3 launches in the "
                             f"bf16 Stage-1 steps")
    out = dict(k1=k1.launches, forward=forward, dz=dz, k3=k1.dw_launches,
               k3_mma=k1.dw_mma_launches, step_ms=times)
    pet = trainer.generate(volumes(400)[0])
    torch.cuda.synchronize()
    if pet.shape != (TRAIN_BATCH, *IMG, 1) \
            or not bool(torch.isfinite(pet).all()):
        raise AssertionError(f"generated PET {tuple(pet.shape)} is not "
                             f"finite or not of the MRI's shape")
    del trainer, pet
    torch.cuda.empty_cache()
    return out


def gn_inputs(gen, shape, dtype):
    C = shape[-1]
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda")
    bias = torch.randn(C, generator=gen, device="cuda")
    return x, scale, bias


def gn_bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_group_norm(x, scale, bias, groups):
    """``F.group_norm`` on the channels-first view of channels-last x,
    then elu: the one PyTorch call for K5a + fold + K5b (yardstick only)."""
    xc = x.permute(0, 4, 1, 2, 3)
    y = torch.nn.functional.group_norm(xc, groups, scale.to(x.dtype),
                                       bias.to(x.dtype), 1e-5)
    return torch.nn.functional.elu(y)


def check_k5(gen) -> list[dict]:
    """Phase 10, checks and times: K5a and K5b against their plain
    versions at the generator's GroupNorm widths (batch 4) and a ragged
    shape, f32 and bf16, every act (K5b takes the plain sums' fold, so
    both sides see the same statistics); then each timed in bf16 beside
    its bound, its plain version and the library call."""
    from gfe_mamba_torch.ops.conv3d import group_norm_stats
    from gfe_mamba_torch.ops.cuda import group_norm as k5
    from gfe_mamba_torch.ops.group_norm import fold_group_stats, group_norm_act

    # K5a: f32 sums in two orders over up to 2.5M rows; K5b: the same f32
    # arithmetic op by op, rounded once to the output dtype
    tol_a = 1e-5
    tol_b = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
    # ragged: C = 24 takes 16-byte vectors (3 per row in bf16), C = 12
    # the scalar path in bf16
    cases = [((BATCH,) + sp + (C,), GN_GROUPS) for sp, C, _ in CONV_LEVELS]
    cases += [((2, 7, 5, 3, 24), 3), ((2, 7, 5, 3, 12), 3)]
    worst = {"a": 0.0, "b": 0.0}
    for shape, groups in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, scale, bias = gn_inputs(gen, shape, dtype)
            B, C = shape[0], shape[-1]
            xv = x.reshape(B, -1, C)
            got = k5.group_norm_sums_cuda(xv)
            sums = k5.group_norm_sums_plain(xv)
            torch.cuda.synchronize()
            err_a, rel = rel_err(got, sums)
            log(f"K5a check {list(shape)} {str(dtype)[6:]}: max_abs_err="
                f"{err_a:.3e} rel={rel:.3e} (tol {tol_a})")
            if not rel <= tol_a:
                raise AssertionError(f"K5a disagrees with its plain version: "
                                     f"rel {rel} > {tol_a}")
            mean, inv = fold_group_stats(sums, xv.shape[1], groups, 1e-5)
            errs = []
            for act in GN_ACTS:
                got = k5.group_norm_apply_cuda(xv, mean, inv, scale, bias, act)
                want = k5.group_norm_apply_plain(xv, mean, inv, scale, bias,
                                                 act)
                torch.cuda.synchronize()
                errs.append(rel_err(got, want))
                del got, want
            err, rel = max(e for e, _ in errs), max(r for _, r in errs)
            log(f"K5b check {list(shape)} {str(dtype)[6:]} acts {GN_ACTS}: "
                f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol_b[dtype]})")
            if not rel <= tol_b[dtype]:
                raise AssertionError(f"K5b disagrees with its plain version: "
                                     f"{errs}")
            if dtype == torch.bfloat16 and B == BATCH:
                worst["a"] = max(worst["a"], err_a)
                worst["b"] = max(worst["b"], err)
            del x, xv, sums, mean, inv
            torch.cuda.empty_cache()

    # the Function's gradients (the VJP of _reference) against autograd
    # through _reference, f32, elu, at the 128-channel width
    from gfe_mamba_torch.ops.group_norm import _reference
    shape = (BATCH,) + CONV_LEVELS[1][0] + (CONV_LEVELS[1][1],)
    x, scale, bias = gn_inputs(gen, shape, torch.float32)
    g = torch.randn(*shape, generator=gen, device="cuda")
    grads = []
    for fn in (lambda *a: group_norm_act(*a, num_groups=GN_GROUPS,
                                         act="elu"),
               lambda *a: _reference(*a, GN_GROUPS, 1e-5, "elu")):
        ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
        grads.append(torch.autograd.grad(fn(*ins), ins, g))
    torch.cuda.synchronize()
    for name, got, want in zip(("dx", "dscale", "dbias"), *grads):
        err, rel = rel_err(got, want)
        log(f"group-norm Function check {list(shape)} f32 act=elu: {name} "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"group-norm Function {name} disagrees "
                                 f"with autograd of _reference")
    del x, scale, bias, g, grads
    torch.cuda.empty_cache()

    rows = {"a": [], "b": []}
    for spatial, C, _ in CONV_LEVELS:
        shape = (BATCH,) + spatial + (C,)
        x, scale, bias = gn_inputs(gen, shape, torch.bfloat16)
        xv = x.reshape(BATCH, -1, C)
        sums = k5.group_norm_sums_cuda(xv)
        mean, inv = fold_group_stats(sums, xv.shape[1], GN_GROUPS, 1e-5)
        n, nbytes = x.numel(), x.numel() * x.element_size()
        ms_a = time_ms(lambda: k5.group_norm_sums_cuda(xv), reps=20)
        plain_a = time_ms(lambda: k5.group_norm_sums_plain(xv))
        lib_a = time_ms(lambda: group_norm_stats(x, GN_GROUPS))
        bound_a, by_a = gn_bound_ms(nbytes + 4 * 2 * BATCH * C, 2 * n)
        ms_b = time_ms(lambda: k5.group_norm_apply_cuda(
            xv, mean, inv, scale, bias, "elu"), reps=20)
        plain_b = time_ms(lambda: k5.group_norm_apply_plain(
            xv, mean, inv, scale, bias, "elu"))
        lib_b = time_ms(lambda: library_group_norm(x, scale, bias, GN_GROUPS))
        bound_b, by_b = gn_bound_ms(2 * nbytes + 4 * 4 * BATCH * C, 6 * n)
        entry = time_ms(lambda: group_norm_act(
            x, scale, bias, num_groups=GN_GROUPS, act="elu"), reps=20)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = torch.nn.functional.group_norm(
            x.permute(0, 4, 1, 2, 3), GN_GROUPS, scale.to(x.dtype),
            bias.to(x.dtype), 1e-5)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / nbytes
        copied = extra > 1.5
        note = (f"F.group_norm on the permuted view: peak {extra:.2f}x x's "
                f"bytes, output channels_last_3d="
                f"{y.is_contiguous(memory_format=torch.channels_last_3d)}, "
                f"input {'copied' if copied else 'not copied'}")
        del y
        log(f"K5a time {list(shape)} bf16: kernel {ms_a:.4f} ms, plain "
            f"{plain_a:.4f} ms, group_norm_stats {lib_a:.4f} ms, bound "
            f"{bound_a:.4f} ms ({by_a})")
        log(f"K5b time {list(shape)} bf16 elu: kernel {ms_b:.4f} ms, plain "
            f"{plain_b:.4f} ms, bound {bound_b:.4f} ms ({by_b}); "
            f"group_norm_act {entry:.4f} ms against F.group_norm + elu "
            f"{lib_b:.4f} ms; {note}")
        rows["a"].append(dict(shape=list(shape), ms=ms_a, plain_ms=plain_a,
                              library_ms=lib_a, bound_ms=bound_a,
                              bound_by=by_a))
        rows["b"].append(dict(shape=list(shape), ms=ms_b, plain_ms=plain_b,
                              library_ms=lib_b, bound_ms=bound_b,
                              bound_by=by_b, group_norm_act_ms=entry,
                              library_copied_input=copied))
        del x, xv, sums, mean, inv
        torch.cuda.empty_cache()

    def entry(key, name, line, library):
        per_shape = rows[key]
        totals = {k: sum(r[k] for r in per_shape)
                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        return dict(name=name, route="cuda",
                    source="gfe_mamba_torch/csrc/group_norm.cu",
                    replaces=f"gfe_mamba_tpu/ops/pallas/group_norm.py:{line}",
                    max_abs_err=worst[key], bound_by="bytes",
                    per="one group_norm_act call at each of the three "
                        "generator widths, batch 4, bf16",
                    library=library, per_shape=per_shape, **totals)

    k5b = entry("b", "K5b group-norm apply + act", 47,
                "F.group_norm + F.elu on the channels-first view: K5a, "
                "the fold and K5b together")
    k5b["group_norm_act_ms"] = sum(r["group_norm_act_ms"]
                                   for r in rows["b"])
    return [entry("a", "K5a group-norm statistics", 32,
                  "group_norm_stats (torch.sum + vector_norm)"), k5b]


def drive_group_norm(card: str) -> tuple[int, int]:
    """Phase 10, the path: ``group_norm_act`` forward and backward at the
    three generator widths, batch 4, bf16, elu (the 'cge' order's GroupNorm
    + ELU); exactly one K5a and one K5b launch per call; each output
    finite and within bf16 rounding of the two-pass ``_reference``."""
    from gfe_mamba_torch.ops.cuda import group_norm as k5
    from gfe_mamba_torch.ops.group_norm import _reference, group_norm_act

    gen = torch.Generator(device="cuda").manual_seed(40)
    k5.stats_launches = k5.apply_launches = 0
    for spatial, C, _ in CONV_LEVELS:
        shape = (BATCH,) + spatial + (C,)
        x, scale, bias = gn_inputs(gen, shape, torch.bfloat16)
        ins = [t.requires_grad_() for t in (x, scale, bias)]
        before = (k5.stats_launches, k5.apply_launches)
        t = time.perf_counter()
        y = group_norm_act(*ins, num_groups=GN_GROUPS, act="elu")
        y.backward(torch.randn(*shape, generator=gen,
                               device="cuda").to(y.dtype))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        per = (k5.stats_launches - before[0], k5.apply_launches - before[1])
        with torch.no_grad():
            err, rel = rel_err(y, _reference(x, scale, bias, GN_GROUPS, 1e-5,
                                             "elu"))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (y, *(i.grad for i in ins)))
        log(f"group_norm_act {list(shape)} bf16 elu forward+backward: "
            f"{dt * 1e3:.1f} ms [{card}]; K5a {per[0]}, K5b {per[1]} "
            f"launches; vs _reference max_abs_err={err:.3e} rel={rel:.3e} "
            f"(tol 2^-6)")
        if per != (1, 1):
            raise AssertionError(f"expected 1 K5a and 1 K5b launch per "
                                 f"group_norm_act call, got {per}")
        if y.shape != shape or not finite or not rel <= 2.0 ** -6:
            raise AssertionError("group_norm_act: bad, non-finite or "
                                 "wrong output")
        del x, scale, bias, ins, y
        torch.cuda.empty_cache()
    return k5.stats_launches, k5.apply_launches


def check_skipped_step() -> None:
    """Phase 11: a Stage-2 step with a NaN in x_num, then a finite one, on
    the card (full widths, (64,64,32), f32).  The skipped step moves no
    parameter and no moment but counts; the finite step is Adam's update
    at count 2, (m / (1 - b1^2)) / (sqrt(v / (1 - b2^2)) + eps), about
    0.74 lr per entry where count 1 would move lr."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    img = (64, 64, 32)
    t = time.perf_counter()
    model = build_gfe_mamba(device="cuda", seed=3, img_size=img,
                            vit_patch_size=16, vit_dropout=0.0,
                            vit_emb_dropout=0.0, cross_ff_dropout=0.0,
                            **CANONICAL)
    trainer = ClassifyTrainer(model, mixed_precision="none", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    mri = torch.randn(2, *img, 1, generator=gen, device="cuda")
    x_cat = torch.randint(0, 6, (2, 8), generator=gen, device="cuda")
    x_num = torch.randn(2, 40, generator=gen, device="cuda")
    labels = torch.tensor([1.0, 0.0], device="cuda")
    params = list(trainer.trainable.values())
    before = [p.detach().clone() for p in params]
    bad = x_num.clone()
    bad[0, 0] = float("nan")
    skipped = trainer.train_step(mri, x_cat, bad, labels)["skipped"]
    state = [trainer.optimizer.state[p] for p in params]
    if skipped != 1.0 or any(s["step"].item() != 1 or s["exp_avg"].any()
                             or s["exp_avg_sq"].any() for s in state) \
            or not all(torch.equal(p, b) for p, b in zip(params, before)):
        raise AssertionError("skipped Stage-2 step: parameters or moments "
                             "moved, or Adam's count is not 1")
    logs = trainer.train_step(mri, x_cat, x_num, labels)
    group = trainer.optimizer.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    worst, moved = 0.0, []
    for p, p0, s in zip(params, before, state):
        want = p0 - lr * (s["exp_avg"] / (1 - b1 ** 2)) / (
            (s["exp_avg_sq"] / (1 - b2 ** 2)).sqrt() + eps)
        tol = 1e-3 * lr + 2.5e-7 * p0.abs().clamp(min=1.0)
        worst = max(worst, ((p.detach() - want).abs() / tol).max().item())
        big = s["exp_avg"].abs() > 1e-6
        moved.append(((p.detach() - p0).abs()[big] / lr).flatten())
    moved = torch.cat(moved)
    counts = {s["step"].item() for s in state}
    log(f"skipped-then-finite Stage-2 step {img} f32: skipped {skipped}, "
        f"then {logs}; Adam steps {counts}; update error / tolerance "
        f"{worst:.3e}; |update| / lr over entries with |m| > 1e-6: median "
        f"{moved.median().item():.4f} (count 2: 0.7441; count 1: 1.0); "
        f"{time.perf_counter() - t:.1f} s")
    if logs["skipped"] or counts != {2} or not worst <= 1.0:
        raise AssertionError("the finite step after a skipped one is not "
                             "Adam's update at count 2")
    del trainer, model
    torch.cuda.empty_cache()


def check_skipped_gan_step() -> None:
    """Phase 11, Stage 1: ``GanTrainer`` (full widths, (64,64,32), f32,
    adversary on) with ``d_fresh_recon`` off and on takes a finite step,
    then one with a NaN in the PET, then a finite one.  The NaN step moves
    no parameter and no Adam moment of G or D (bit for bit) and advances
    both players' Adam counts, as optax's count advances under the JAX
    trainer's finite guard; the next step is finite and counts too."""
    from gfe_mamba_torch.losses.perceptual import PerceptualLoss
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.training.gan_trainer import GanTrainer

    img = (64, 64, 32)
    gen = torch.Generator(device="cuda").manual_seed(32)
    mri, pet = (torch.randn(TRAIN_BATCH, *img, 1, generator=gen,
                            device="cuda") for _ in range(2))
    bad = pet.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    for fresh in (False, True):
        t = time.perf_counter()
        disc = PatchDiscriminator(3, 32)
        disc.reset_parameters(torch.Generator().manual_seed(5))
        trainer = GanTrainer(
            build_generator(device="cuda", seed=4, img_size=img,
                            vit_patch_size=16, vit_dropout=0.0,
                            vit_emb_dropout=0.0),
            disc, PerceptualLoss(0.25, device="cuda"),
            mixed_precision="none", d_fresh_recon=fresh, device="cuda")
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
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        log(f"skipped Stage-1 step {img} f32 d_fresh_recon={fresh}: skipped "
            f"{[lg['skipped'] for lg in logs]}; G and D Adam counts after "
            f"the NaN step {skipped_counts}, after the next {counts()}; "
            f"parameters and moments bitwise equal across the skip: {same}; "
            f"{time.perf_counter() - t:.1f} s")
        if [lg["skipped"] for lg in logs] != [0.0, 1.0, 0.0] \
                or skipped_counts != [{2}, {2}] or counts() != [{3}, {3}] \
                or not same \
                or not all(math.isfinite(v) for v in logs[2].values()):
            raise AssertionError(f"skipped Stage-1 step (d_fresh_recon="
                                 f"{fresh}) moved a parameter or a moment, "
                                 f"or the counts did not advance")
        del trainer, disc, before, after
        torch.cuda.empty_cache()


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


def cpu_state(module) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in module.state_dict().items()}


def states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def adam_equal(a: dict, b: dict) -> bool:
    """Two ``torch.optim.Adam`` state dicts, every tensor bitwise."""
    sa, sb = a["state"], b["state"]
    return sa.keys() == sb.keys() and all(
        sa[i].keys() == sb[i].keys()
        and all(torch.equal(torch.as_tensor(sa[i][k]).cpu(),
                            torch.as_tensor(sb[i][k]).cpu())
                for k in sa[i]) for i in sa)


def drive_clis(card: str) -> None:
    """Phase 12: the three entry points a user runs, through their
    ``main``, on the card at full width (160x160x96, f_maps 64/128/256,
    dim 512, depth 6, bf16) over synthetic trees written to a temporary
    directory: 2 MRI/PET subjects; 4 train and 2 eval classify items on
    one CSV.  Stage 1 (batch 1, 2 steps, remat as ``main_gan_vit``'s
    default, auto-resume on, then validation and save) -> Stage 2 on its
    ``model.npz`` (batch 2, 2 steps, validation, save) -> ``test_mamba``
    over the saved npz.  Checks: Stage 2's generator is Stage 1's last
    state bitwise; ``test_mamba``'s combiner and classifier are Stage
    2's bitwise; its printed metrics are those of
    ``ClassifyTrainer.eval_step`` over the same batches (Stage 2's last
    validation, same weights); ``AutoResume.restore_latest`` gives Stage
    1's last snapshot (step, epoch, both players and both Adams bitwise);
    K1, K2, K3 and K4 each launch in the phase."""
    import argparse
    import contextlib
    import io
    import shutil
    import tempfile

    from gfe_mamba_torch.cli import classify_mamba, main_gan_vit, test_mamba
    from gfe_mamba_torch.config import load_config
    from gfe_mamba_torch.data import datasets
    from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                                make_mri2pet_tree)
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    with tempfile.TemporaryDirectory(prefix="gfe_cli_") as root:
        t = time.perf_counter()
        pairs = make_mri2pet_tree(os.path.join(root, "pairs"), 2, IMG)
        vol_dir, csv_path = make_classify_tree(os.path.join(root, "cls"), 6,
                                               IMG)
        eval_dir = os.path.join(root, "cls", "eval")
        os.makedirs(eval_dir)
        for name in sorted(os.listdir(vol_dir))[4:]:
            shutil.move(os.path.join(vol_dir, name), eval_dir)
        log(f"CLI phase: synthetic trees {IMG} written in "
            f"{time.perf_counter() - t:.1f} s")
        run = dict(num_epochs=1, val_inter=1, save_inter=1, is_debug=False,
                   autoresume=True, log_every=1,
                   f_maps=list(CANONICAL["f_maps"]), mixed_precision="bf16",
                   img_sz=list(IMG))
        configs = {}
        for name, source, extra in (
                ("gan", "main_gan_vit_config.yaml", dict(
                    train_path=pairs, eval_path=pairs, train_bc=1,
                    eval_bc=1, project_dir=os.path.join(root, "w"))),
                ("cls", "classify_mamba_config.yaml", dict(
                    train_path=vol_dir, eval_path=eval_dir,
                    table_path=csv_path, train_bc=2, eval_bc=2,
                    dim=CANONICAL["dim"], depth=CANONICAL["depth"],
                    project_dir=os.path.join(root, "w", "classifier"))),
                ("test", "classify_mamba_config_test.yaml", dict(
                    train_path=vol_dir, eval_path=eval_dir,
                    table_path=csv_path, eval_bc=2, dim=CANONICAL["dim"],
                    depth=CANONICAL["depth"], use_best=False,
                    project_dir=os.path.join(root, "w", "test")))):
            cf = dict(load_config(os.path.join(REPO, "configs", source)))
            cf.update(run, **extra)
            configs[name] = cf
        paths = {}

        def write(name):
            paths[name] = os.path.join(root, f"{name}.yaml")
            with open(paths[name], "w") as f:
                f.write(yaml_text(configs[name]))
            return argparse.Namespace(config_path=paths[name], device="cuda")

        torch.cuda.synchronize()
        k1.launches = k1.dw_launches = 0
        k2.launches = k2.bwd_launches = 0
        datasets.CODEC_RUNS.clear()
        walls = {}

        t = time.perf_counter()
        s1 = main_gan_vit.main(write("gan"))
        torch.cuda.synchronize()
        walls["main_gan_vit"] = time.perf_counter() - t
        trainer = s1["trainer"]
        g_end = cpu_state(trainer.generator)
        d_end = cpu_state(trainer.discriminator)
        g_opt_end = copy.deepcopy(trainer.g_opt.state_dict())
        d_opt_end = copy.deepcopy(trainer.d_opt.state_dict())
        loader = s1["train_loader"]
        stage1 = dict(step_ms=s1["step_ms"],
                      wait_ms=loader.wait_s / max(loader.batches, 1) * 1e3,
                      launches=(k1.launches, k1.dw_launches))
        step, payload = s1["auto"].restore_latest(map_location="cpu")
        gan = payload["gan"]
        if step != len(s1["step_ms"]) or payload["epoch"] != 1 \
                or not states_equal(gan["generator"], g_end) \
                or not states_equal(gan["discriminator"], d_end) \
                or not adam_equal(gan["g_opt"], g_opt_end) \
                or not adam_equal(gan["d_opt"], d_opt_end):
            raise AssertionError(f"AutoResume.restore_latest: step {step}, "
                                 f"epoch {payload['epoch']}, or weights / "
                                 f"Adam state differ from Stage 1's end")
        # what a restarted run does with it: load, then a finite step
        trainer.load_state_dict(gan)
        gen = torch.Generator(device="cuda").manual_seed(12)
        logs = trainer.train_step(
            *(torch.randn(1, *IMG, 1, generator=gen, device="cuda")
              for _ in range(2)), 0.0)
        if logs["skipped"] or not all(math.isfinite(v)
                                      for v in logs.values()):
            raise AssertionError(f"a step after loading the snapshot: {logs}")
        log(f"CLI phase: AutoResume.restore_latest -> step {step}, epoch "
            f"{payload['epoch']}, both players and both Adams bitwise "
            f"Stage 1's last state; loaded into the trainer, it takes a "
            f"finite step ({logs['g_loss']:.4f})")
        del s1, trainer, payload, gan, g_opt_end, d_opt_end
        torch.cuda.empty_cache()

        runs = [r for r in os.listdir(os.path.join(root, "w"))
                if r.startswith("exp_")]
        npz = os.path.join(root, "w", runs[0], "model_save", "model.npz")
        configs["cls"]["gan_ckpt"] = configs["test"]["gan_ckpt"] = npz
        t = time.perf_counter()
        s2 = classify_mamba.main(write("cls"))
        torch.cuda.synchronize()
        walls["classify_mamba"] = time.perf_counter() - t
        model2 = s2["trainer"].model
        if not states_equal(cpu_state(model2.generator), g_end):
            raise AssertionError("Stage 2's generator is not Stage 1's "
                                 "last state")
        loader = s2["train_loader"]
        stage2 = dict(step_ms=s2["step_ms"],
                      wait_ms=loader.wait_s / max(loader.batches, 1) * 1e3)
        parts = {p: cpu_state(getattr(model2, p))
                 for p in ("combiner", "classifier")}
        val = s2["validation"]
        del s2, model2
        torch.cuda.empty_cache()

        configs["test"]["pth_dir"] = os.path.join(
            root, "w", "classifier",
            [r for r in os.listdir(os.path.join(root, "w", "classifier"))
             if r.startswith("exp_")][0], "model_current")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            s3 = test_mamba.main(write("test"))
        torch.cuda.synchronize()
        walls["test_mamba"] = time.perf_counter() - t
        printed = out.getvalue()
        for line in printed.strip().splitlines():
            log(f"  test_mamba: {line}")
        for p, state in parts.items():
            if not states_equal(cpu_state(getattr(s3["model"], p)), state):
                raise AssertionError(f"test_mamba's {p} is not what Stage 2 "
                                     f"saved")
        m = val["metrics"]
        want = [f"Acc: {m['accuracy'] * 100: .4f}",
                f"Recall: {m['recall']: .4f}", f"F1: {m['f1']:.4f}",
                f"Pre: {m['precision']:.4f}", f"MCC: {m['mcc']:.4f}",
                f"Val_loss: {val['val_loss']: .4f}"]
        if printed.strip().splitlines() != want:
            raise AssertionError(f"test_mamba printed {printed!r}; "
                                 f"eval_step gives {want}")
        log(f"CLI phase: test_mamba's metrics equal eval_step's over the "
            f"same batches (raw: {s3['metrics']} loss {s3['val_loss']} "
            f"against {m} loss {val['val_loss']})")
        del s3
        torch.cuda.empty_cache()

    counts = dict(K1=k1.launches, K2=k2.launches, K3=k1.dw_launches,
                  K4=k2.bwd_launches)
    for name, wall in walls.items():
        log(f"CLI phase: {name} {wall:.1f} s wall [{card}]")
    log(f"CLI phase: Stage-1 steps {['%.1f' % v for v in stage1['step_ms']]}"
        f" ms, loader wait {stage1['wait_ms']:.1f} ms per batch; Stage-2 "
        f"steps {['%.1f' % v for v in stage2['step_ms']]} ms, loader wait "
        f"{stage2['wait_ms']:.1f} ms per batch [{card}]")
    log(f"CLI phase: volumes decoded by codec {dict(datasets.CODEC_RUNS)}; "
        f"launches in the phase {counts} (Stage 1 alone: K1 "
        f"{stage1['launches'][0]}, K3 {stage1['launches'][1]})")
    missing = [name for name, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"{missing} never launched in the CLI phase")


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    sys.path.insert(0, REPO)
    from gfe_mamba_torch.ops.cuda import build

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    t = time.perf_counter()
    reports = build.build()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_k1(gen), check_k2(gen)]
    check_pipeline_parity()
    k1_launches, k2_launches = serve_canonical(card)
    kernels[0]["launches"] = k1_launches
    kernels[1]["launches"] = k2_launches
    k4, k3 = check_k4(gen), check_k3(gen)
    kernels[0]["dz"] = check_k1_dz(gen)
    check_conv_function(gen)
    check_training_parity()
    stage2 = train_stage2_canonical(card)
    stage1 = train_stage1_canonical(card)
    k4["launches"] = stage2["k4"]
    k3["launches"] = stage1["k3"]
    k3["tensor_core_launches"] = stage1["k3_mma"]
    kernels[0]["dz_launches"] = stage1["dz"]
    kernels += [k4, k3]
    k5 = check_k5(gen)
    k5[0]["launches"], k5[1]["launches"] = drive_group_norm(card)
    kernels += k5
    check_skipped_step()
    check_skipped_gan_step()
    drive_clis(card)
    log(f"Stage-2 ms/step {stage2['step_ms']}, Stage-1 ms/step "
        f"{stage1['step_ms']} [{card}]")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
