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
   (under the process's own TF32 settings, as a user's run has them)
   over synthetic trees in a temporary directory (configs from
   ``configs/*.yaml``, 1 epoch, bf16): ``main_gan_vit`` (batch 1, 2 steps,
   remat, auto-resume) -> ``classify_mamba`` on its ``model.npz`` (batch
   2, 2 steps) -> ``test_mamba`` on the saved npz; the weights each hands
   on must be bitwise the giver's, ``test_mamba``'s printed metrics those
   of ``ClassifyTrainer.eval_step`` over the same batches, the newest
   auto-resume snapshot Stage 1's last state (both Adams too), and K1-K4
   must each launch; each CLI's wall, its step times, the loader's wait
   per batch and the codec that decoded each volume are logged;
13. the other Stage-2 mixers: (a) ``CrossJambaBoth`` and
   ``CrossTransformerBoth`` at the canonical width (dim 512, depth 6, 8
   heads, 16 experts top-2, L = 53) in f32, card against CPU within rel
   1e-3, K2 11 times for Jamba's 11 Mamba layers and never for the
   transformer; (d) the Jamba stack of (a) and a 6-layer Mamba stepped
   token by token over the 53 tokens equal their forward within rel 1e-4
   on the card, and ``generate(top_k=1)`` of a ``JambaLM`` of that width
   is the greedy argmax of its forward; (b) ``build_gfe_mamba`` with
   ``mixer="jamba"`` and ``"transformer"`` serves 3 canonical requests
   each (bf16, batch 4): K1 10 and K2 11 / 0 launches per request; (c)
   ``ClassifyTrainer`` over the Jamba pipeline, bf16, batch 1, dropout on,
   1 warm-up then 3 steps: K1 10, K2 11 and K4 11 per step; (e)
   ``classify_mamba`` with ``mixer: 'jamba'`` on phase 12's tree and
   Stage-1 npz, ``test_mamba`` on its checkpoint (phase 12's checks), and
   ``ft_table`` for 2 epochs on the synthetic CSV, whose lines must have
   the JAX script's form;
14. the parallel layer: (a) two gloo ranks on the one card at the
   canonical width, each at batch 1, dropout off: one Stage-2 step (Mamba
   head) and one Stage-1 step, against this process stepping the global
   batch of 2 from the same weights (``compare_dp`` states the bf16
   tolerances), both ranks' parameters bitwise equal, each rank launching
   K1, K2, K4 (Stage 2) and K1, K3 (Stage 1), each rank's step time and
   peak memory logged (gloo through the host on one card, not NCCL data
   parallelism); (b) the dry run ``python -m
   gfe_mamba_torch.parallel.dryrun`` at 2 processes on the card (gloo,
   model axis 2: tensor- and expert-parallel projections on CUDA
   tensors); (c) ``torchrun --nproc_per_node 1`` (NCCL at world 1) runs
   the Stage-1 and Stage-2 CLIs on phase 12's tree with ``async_ckpt:
   true``: their npz files bitwise phase 12's, and ``AutoResume`` over
   the async manager restores Stage 1's last state; (a)'s one-process
   references, (b) and (c)'s two runs go at once, each in its own
   processes;
15. the segmentation family, f32 with TF32 off: (a) ``get_model``'s
   UNet3D and ResidualUNet3D at the JAX package's defaults (full width)
   on a 32x64x64 patch, card against CPU within 1e-4 relative, K1 13
   and 18 times per forward (UNet3D's C_in = 1 stem on cuDNN), UNet2D
   (cuDNN only, no K1) and ResidualUNetSE3D at a small width; (d) K1
   (forward, and as dz) and K3 against their plain versions at the
   segmentation widths (32 -> 64 and the concat-joined 192, 384, 768),
   the stem's C_in = 1 refused by K1 and ruled onto cuDNN; (e) the
   UNet3D forward on one 64x128x128 patch timed, with its 13 K1 convs,
   their plain versions, cuDNN's f32 conv and the bound, and per
   training step K1-dz and K3 beside cuDNN's dgrad and wgrad, each of
   the three first held against its plain version at each of the 13
   shapes, each conv's times logged, each kernel's TFLOP/s and share of
   the f32 peak printed beside them; (f) one ``UNetTrainer`` step of that
   UNet3D (order gce, its encoders pooling by average) on a 32x64x64
   patch: the loss and every gradient of the kernels' step against the
   same step with the plain convs on the card (1e-4) and against the CPU
   (twice that witness's own distance); (b)
   ``seg_predict`` over a 96x192x192 volume written by ``data/h5.py``
   (8 patches, batch 4) from a checkpoint of seeded weights: the file
   read back equals ``sliding_window_predict`` driven directly, K1 13
   times per forward; (c) ``seg_train`` at batch 1: 3 steps with one
   validation and both checkpoints, a resume to step 4, ``seg_predict``
   from the best checkpoint; every step K1 13 forward + 13 dz and K3 13
   (f32);
16. the modules outside the main paths, f32 with TF32 off, each part's
   times, errors and peak memory logged; every card-against-CPU error is
   relative to the CPU result's own largest magnitude, which is logged:
   (a) ResNet3D-101 (Kinetics widths, one input channel, one logit) and
   (b) MVCSNet at its defaults, eval, their pooled features (2048 and
   512) card against CPU within 1e-4 at batch 1 on 64x64x48, each
   forward timed at batch 4 on 160x160x96; (c) Jamba-v0.1 at its
   published widths cut to one period of its layers (8: attention at
   4, 16 experts top-2 on the odd ones; 13.3e9 parameters, 53 GB in
   f32), its weights drawn on the card from a seed and handed over
   from the host under HF Jamba's names to ``import_jamba_hf`` on the
   card: every tensor back bitwise, logits of a 64-token prompt at batch
   2 within 1e-4 of the same weights' CPU forward, ``generate`` of 16
   tokens (top_k 1 is the greedy argmax), K2 7 times per forward, and K2
   against its plain version on the first Mamba layer's operands, (2,
   64, 8192, 16) (1e-5); (d) 8 RGBA PNGs of
   256x256 and their masks through ``DSB2018Dataset`` into ``UNet2D`` at
   the JAX defaults on the card, ``dsb_predict``'s files read back by
   ``data/h5.py`` within 1e-4 of the CPU's predictions; (e)
   ``adaptive_normal``, ``foreground_bbox_jax`` and ``crop_resize`` to
   160x160x96 (no host sync: CUDA's sync debug mode raises) and
   ``resize_volume`` on a 256x256x170 volume, within 1e-5 of the CPU;
   (f) the legacy combiners at the generator's skip shapes and
   ``PatchDiscriminator(dims=2)`` on 256x256, within 1e-4 of the CPU;
17. the ViT zoo (``models/vit_zoo*.py``) at the widths of upstream
   vit-pytorch's README examples, f32 with TF32 off, no kernel: each
   model's weights drawn on the CPU from a seed, its pooled features and
   logits card against CPU within 1e-4 of the CPU's largest magnitude,
   its forward timed with its FLOPs and peak memory; (a)-(d) the 2D and
   1D members (ViT-B-like at 256/32, dim 1024, depth 6; CaiT, the patch
   merger and EfficientViT deeper; PiT, T2T, CrossViT, CvT-13, NesT-T,
   MobileViT, CCT-14/7x2 at their own widths), the CPU at batch 2, the
   card timed at batch 32 (SimpleViTPatchDropout in train mode, the
   parity's scores shared); (e) ViT3D, SimpleViT3D, ViViT and CCT3D,
   each CPU model's state_dict (the reference's names) loaded onto the
   card by its importer and checked at 48x64x64 (batch 1), then timed at
   batch 4 on GFE-Mamba's 96x160x160 volume; (f) MAE, MPP and DINO's head
   with ``dino_loss``: the loss and every gradient within 1e-4 of the
   CPU's at batch 4 with the masking draws shared, ``ema_update`` within
   1e-6, then loss + backward timed at batch 32; (g) ``augment2d`` on 32
   images of 256x256x3: each op and ``ssl_views_batch`` (224 and 96)
   within 1e-5 of the CPU with the CPU's draws replayed on the card under
   CUDA's sync debug mode set to raise, each timed;
18. the ViT zoo's second half (``models/vit_zoo_hier.py``,
   ``models/vit_zoo_final.py``) at the README examples' widths, f32 with
   TF32 off, eval mode, no kernel: weights drawn on the CPU from a seed,
   each output card against CPU at batch 2 within 1e-4 of the CPU's
   largest magnitude, then timed at batch 32 with its FLOPs and peak
   memory: (a) LeViT, MaxViT, TwinsSVT, XCiT, CrossFormer, RegionViT,
   ScalableViT, SepViT; (b) MaxViT with 4 registers, RvT, the memory
   adapter (5 memories per layer, 2 classes); (c) ATSViT with the CPU's
   Gumbel uniforms handed to the card, its sampled ids exactly the CPU's
   before its logits are compared; (d) NaViT over the README's five
   images packed by the port's packer, timed over 32 images of mixed
   sides packed at ``max_seq_len`` 256; (e) SimMIM, MP3, DistillWrapper
   and EsViT's projector with both losses: loss and every gradient
   against the CPU with the draws shared, loss + backward timed;
   (f) ``extract`` and ``record_attention`` on phase 17(a)'s ViT-B-like
   ClassifierViT: maps against the CPU, rows summing to 1, the logits
   with the hooks bitwise those without them;
19. what closes the port: (a) every name of the nine ``__init__.py``
   files' re-exports resolves (89 names and ``config``), with no JAX on
   the machine, and ``ops.scan.linear_recurrence`` at (4, 53, 1024) f32
   in both modes against the CPU (1e-5 of the CPU's largest magnitude);
   (b) ``cli/generation_evaluation`` (f32, TF32 off) over 2 batches of a
   synthetic 160x160x96 tree with the canonical generator of
   ``configs/main_gan_vit_config.yaml`` from a seeded npz: K1 10 times
   per batch (its f32 variant; phase 3 holds that variant with and
   without the residual epilogue at each level), the first batch's PSNR
   and MSE against the same tool on the CPU within twice the distance
   of a witness run on the card with the plain convs (and 1e-3,
   relative), each batch timed; (c) ``cli/view_nii --normalize`` on one written NIfTI:
   the PNG decodes to the grid computed on the CPU, exactly; (d)
   ``quality_torch.py --smoke`` at the small geometry (f32) and at the
   canonical one (160x160x96, its widths, bf16, 4 + 2 + 2 subjects):
   K1, K1-dz, K3, K2 and K4 each launched (K1-dz read inside the conv
   Function's backward), the metrics finite; K1 (both epilogues), K1-dz
   and K3 against their plain versions at the small path's f32 shapes,
   K2 and K4 at the scan shape its Stage 2 gave (the canonical path's
   shapes and dtypes are phases 3 and 6's).

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
K5b the 3 calls of phase 10; K2's ``jamba_launches`` the 3 Jamba
requests of phase 13(b), K4's the 3 Jamba Stage-2 steps of 13(c), K2's
``hf_jamba_launches`` the forward and ``generate`` of phase 16(c), with
its check and times on that model's first layer as ``hf_jamba``;
``dp_launches`` (K1-K4) rank 0's launches in phase 14(a), K1's summed
over its Stage-2 and Stage-1 steps; K1's and K3's ``seg_launches``
their launches over phase 15(b) and (c), and ``seg`` their f32 times
of 15(e) (K1 per UNet3D forward, its dz and K3 per training step) with
their TFLOP/s and shares of the f32 peak; every kernel's
``quality_launches`` its launches over phase 19(d)'s smoke run of each
geometry (K1's forward ones, its dz in ``quality_dz_launches``), and
K1's ``gen_eval_launches`` those of phase 19(b).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# the f32 variants' designs (the segmentation path's), for the kernels line
K1_F32_VERSION = ("f32 v2: CUDA-core implicit GEMM, 8 z rows x 8 channels "
                  "per thread, 8-channel chunks in a 2-stage cp.async ring, "
                  "32-channel tile where F <= 32")
K3_F32_VERSION = ("f32 v2: the 9 taps of one dx per block over a "
                  "double-buffered cp.async x slab, 4x4 per tap per thread, "
                  "makespan-balanced split-K")
# phase 13: CrossJambaBoth at depth 6 has 12 layers, layer 4 attention,
# so 11 Mamba layers (K2 per forward, K4 per Stage-2 step); its parity
# against the CPU runs on the slice tokens of volumes this size
JAMBA_SCANS = 11
MIXER_PARITY_IMG = (64, 64, 32)
# group_norm_act (K5) runs at the generator's GroupNorm widths (the conv
# levels above), 8 groups
GN_GROUPS = 8
GN_ACTS = ("none", "elu", "relu", "leaky_relu")
# phase 15: the segmentation family at the JAX package's get_model
# defaults (pytorch3dunet's), f32; K1 launches per forward, the C_in = 1
# stem of UNet3D going to cuDNN
SEG_UNET3D = dict(name="UNet3D", in_channels=1, out_channels=1, f_maps=64,
                  layer_order="gcr", num_groups=8)
SEG_FORWARD_K1 = {"UNet3D": 13, "ResidualUNet3D": 18}
SEG_PATCH = (64, 128, 128)
# (a): both families at full width, UNet2D (cuDNN only) and the SE family
# at a small width
SEG_PARITY_CASES = (
    (SEG_UNET3D, (1, 32, 64, 64, 1)),
    (dict(name="ResidualUNet3D", in_channels=1, out_channels=1),
     (1, 32, 64, 64, 1)),
    (dict(name="UNet2D", in_channels=1, out_channels=3, f_maps=16,
          final_sigmoid=False), (2, 128, 128, 1)),
    (dict(name="ResidualUNetSE3D", in_channels=2, out_channels=2, f_maps=16,
          num_levels=4), (1, 32, 32, 32, 2)))
SEG_VOLUME = (96, 192, 192)
SEG_STRIDE = (32, 64, 64)
SEG_BATCH = 4
# K1 / K3 checks at the segmentation widths (C, F): the stem (refused by
# K1, cuDNN's), DoubleConv's 32 -> 64, the concat-joined decoder inputs
SEG_CHECK_SHAPE = (1, 12, 20, 24)
SEG_CHECK_WIDTHS = ((32, 64), (192, 64), (384, 128), (768, 256))


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


def serve_canonical(card: str, mixer: str = "mamba",
                    scans: int = SCAN_CALLS) -> tuple[int, int, list]:
    """The main path: 3 requests of batch 4 at the canonical size, bf16,
    with the ``mixer`` head, whose forward runs K2 ``scans`` times.
    Returns the K1 and K2 launches and each request's ms."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    t0 = time.perf_counter()
    model = build_gfe_mamba(img_size=IMG, device="cuda",
                            dtype=torch.bfloat16, seed=0, mixer=mixer,
                            **CANONICAL)
    log(f"canonical {mixer} model built in {time.perf_counter() - t0:.1f} "
        f"s ({sum(p.numel() for p in model.parameters())} parameters)")
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
    times = []
    for i in range(3):
        before = (k1.launches, k2.launches)
        t = time.perf_counter()
        logits, pet = request(i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        times.append(dt * 1e3)
        per = (k1.launches - before[0], k2.launches - before[1])
        ok = (logits.shape == (BATCH, 1) and pet.shape == (BATCH, *IMG, 1)
              and bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(pet).all()))
        log(f"{mixer} request {i}: {dt * 1e3:.1f} ms, {BATCH / dt:.2f} "
            f"volumes/s [{card}]; K1 launches {per[0]}, K2 launches "
            f"{per[1]}; logits {logits.float().flatten().tolist()}")
        if not ok:
            raise AssertionError("canonical forward: bad or non-finite output")
        if per != (10, scans):
            raise AssertionError(f"expected 10 K1 and {scans} K2 launches "
                                 f"per {mixer} forward, got {per}")
    del model
    torch.cuda.empty_cache()
    return k1.launches, k2.launches, times


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


def train_stage2_canonical(card: str, mixer: str = "mamba",
                           scans: int = SCAN_CALLS) -> dict:
    """Stage 2 at the canonical size: 3 bf16 steps of batch 1 with the
    ``mixer`` head (dropout on at the build's rates), whose forward and
    backward run K2 and K4 ``scans`` times each."""
    from gfe_mamba_torch.models.pipeline import build_gfe_mamba
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    from gfe_mamba_torch.training.classify_trainer import ClassifyTrainer

    t0 = time.perf_counter()
    model = build_gfe_mamba(img_size=IMG, device="cuda", seed=0, mixer=mixer,
                            **CANONICAL)
    trainer = ClassifyTrainer(model, device="cuda")
    log(f"Stage-2 {mixer} trainer built in {time.perf_counter() - t0:.1f} s")
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
        log(f"Stage-2 {mixer} step {i}: {dt * 1e3:.1f} ms, "
            f"{TRAIN_BATCH / dt:.2f} volumes/s [{card}]; K1 {per[0]}, K2 "
            f"{per[1]}, K4 {per[2]} launches; {logs}")
        if not math.isfinite(logs["cla_loss"]) or logs["skipped"]:
            raise AssertionError("Stage-2 step: non-finite or skipped")
        if per != (10, scans, scans):
            raise AssertionError(f"expected 10 K1, {scans} K2 and {scans} "
                                 f"K4 launches per Stage-2 {mixer} step, "
                                 f"got {per}")
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


def write_config(root: str, name: str, cf: dict):
    """``cf`` as ``<root>/<name>.yaml``; the CLIs' argument namespace."""
    import argparse

    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(yaml_text(cf))
    return argparse.Namespace(config_path=path, device="cuda")


def only_run(project_dir: str) -> str:
    """The one ``exp_*`` run directory a CLI wrote under ``project_dir``."""
    runs = [r for r in os.listdir(project_dir) if r.startswith("exp_")]
    if len(runs) != 1:
        raise AssertionError(f"{project_dir}: runs {runs}, expected one")
    return os.path.join(project_dir, runs[0])


def stage2_then_evaluation(root: str, configs: dict, tag: str,
                           g_end: dict, walls: dict) -> dict:
    """``classify_mamba`` on ``configs['cls']``, then ``test_mamba`` on its
    ``model_current`` npz with ``configs['test']``.  Checks: Stage 2's
    generator is ``g_end`` bitwise; ``test_mamba``'s combiner and
    classifier are Stage 2's bitwise and its printed metrics are those of
    ``ClassifyTrainer.eval_step`` over the same batches (Stage 2's last
    validation, same weights).  Returns Stage 2's step times, loader wait
    and the classifier's parameter count."""
    import contextlib
    import io

    from gfe_mamba_torch.cli import classify_mamba, test_mamba

    t = time.perf_counter()
    s2 = classify_mamba.main(write_config(root, f"{tag}_cls",
                                          configs["cls"]))
    torch.cuda.synchronize()
    walls["classify_mamba"] = time.perf_counter() - t
    model2 = s2["trainer"].model
    if not states_equal(cpu_state(model2.generator), g_end):
        raise AssertionError(f"{tag}: Stage 2's generator is not Stage 1's "
                             f"last state")
    loader = s2["train_loader"]
    stage2 = dict(step_ms=s2["step_ms"],
                  wait_ms=loader.wait_s / max(loader.batches, 1) * 1e3,
                  classifier_params=sum(p.numel() for p in
                                        model2.classifier.parameters()))
    parts = {p: cpu_state(getattr(model2, p))
             for p in ("combiner", "classifier")}
    val = s2["validation"]
    del s2, model2
    torch.cuda.empty_cache()

    configs["test"]["pth_dir"] = os.path.join(
        only_run(configs["cls"]["project_dir"]), "model_current")
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        s3 = test_mamba.main(write_config(root, f"{tag}_test",
                                          configs["test"]))
    torch.cuda.synchronize()
    walls["test_mamba"] = time.perf_counter() - t
    printed = out.getvalue()
    for line in printed.strip().splitlines():
        log(f"  {tag} test_mamba: {line}")
    for p, state in parts.items():
        if not states_equal(cpu_state(getattr(s3["model"], p)), state):
            raise AssertionError(f"{tag}: test_mamba's {p} is not what "
                                 f"Stage 2 saved")
    m = val["metrics"]
    want = [f"Acc: {m['accuracy'] * 100: .4f}",
            f"Recall: {m['recall']: .4f}", f"F1: {m['f1']:.4f}",
            f"Pre: {m['precision']:.4f}", f"MCC: {m['mcc']:.4f}",
            f"Val_loss: {val['val_loss']: .4f}"]
    if printed.strip().splitlines() != want:
        raise AssertionError(f"{tag}: test_mamba printed {printed!r}; "
                             f"eval_step gives {want}")
    log(f"{tag}: test_mamba's metrics equal eval_step's over the same "
        f"batches (raw: {s3['metrics']} loss {s3['val_loss']} against {m} "
        f"loss {val['val_loss']})")
    del s3
    torch.cuda.empty_cache()
    return stage2


def drive_clis(card: str, root: str) -> dict:
    """Phase 12: the three entry points a user runs, through their
    ``main``, on the card at full width (160x160x96, f_maps 64/128/256,
    dim 512, depth 6, bf16) over synthetic trees written to ``root``: 2
    MRI/PET subjects; 4 train and 2 eval classify items on one CSV.
    Stage 1 (batch 1, 2 steps, remat as ``main_gan_vit``'s default,
    auto-resume on, then validation and save) -> Stage 2 on its
    ``model.npz`` (batch 2, 2 steps, validation, save) -> ``test_mamba``
    over the saved npz.  Checks: those of :func:`stage2_then_evaluation`;
    ``AutoResume.restore_latest`` gives Stage 1's last snapshot (step,
    epoch, both players and both Adams bitwise); K1, K2, K3 and K4 each
    launch in the phase.  Returns what phase 13 reuses: the configs, the
    Stage-1 npz and its generator state, the CSV."""
    import shutil

    from gfe_mamba_torch.cli import main_gan_vit
    from gfe_mamba_torch.config import load_config
    from gfe_mamba_torch.data import datasets
    from gfe_mamba_torch.data.synthetic import (make_classify_tree,
                                                make_mri2pet_tree)
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

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

    torch.cuda.synchronize()
    k1.launches = k1.dw_launches = 0
    k2.launches = k2.bwd_launches = 0
    datasets.CODEC_RUNS.clear()
    walls = {}

    t = time.perf_counter()
    s1 = main_gan_vit.main(write_config(root, "gan", configs["gan"]))
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
    if logs["skipped"] or not all(math.isfinite(v) for v in logs.values()):
        raise AssertionError(f"a step after loading the snapshot: {logs}")
    log(f"CLI phase: AutoResume.restore_latest -> step {step}, epoch "
        f"{payload['epoch']}, both players and both Adams bitwise "
        f"Stage 1's last state; loaded into the trainer, it takes a "
        f"finite step ({logs['g_loss']:.4f})")
    del s1, trainer, payload, gan, g_opt_end, d_opt_end
    torch.cuda.empty_cache()

    npz = os.path.join(only_run(os.path.join(root, "w")), "model_save",
                       "model.npz")
    configs["cls"]["gan_ckpt"] = configs["test"]["gan_ckpt"] = npz
    stage2 = stage2_then_evaluation(root, configs, "CLI phase", g_end,
                                    walls)

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
    return dict(configs=configs, g_end=g_end, csv=csv_path)


def materialized(make, seed: int):
    """``make()`` built on the meta device and filled on the CPU from
    ``seed`` under the torch law, as ``build_gfe_mamba`` fills a model."""
    from gfe_mamba_torch.utils.initializers import init_weights

    with torch.device("meta"):
        module = make()
    module.to_empty(device="cpu")
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


def check_other_heads_parity():
    """Phase 13(a): ``CrossJambaBoth`` and ``CrossTransformerBoth`` at the
    canonical width (dim 512, depth 6, 8 heads; Jamba's 16 experts top-2)
    on classifier inputs of the canonical table (L = 53 tokens), f32, the
    slice tokens of two (64,64,32) volumes: CPU (plain versions) against
    the card (kernels: K2 for Jamba's 11 Mamba layers) from the same
    weights.  Returns the Jamba head on the card and the inputs."""
    from gfe_mamba_torch.models.ft_transformer import CrossTransformerBoth
    from gfe_mamba_torch.models.fusion import CrossJambaBoth
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    cats, ncont = CANONICAL["categories"], CANONICAL["num_continuous"]
    dim, heads = CANONICAL["dim"], CANONICAL["heads"]
    img = MIXER_PARITY_IMG
    gen = torch.Generator().manual_seed(13)
    inputs = (torch.randint(0, 6, (2, len(cats)), generator=gen),
              torch.randn(2, ncont, generator=gen),
              torch.randn(2, CANONICAL["seq_length"], dim, generator=gen),
              [torch.randn(2, *img, 1, generator=gen) for _ in range(2)])
    common = dict(dim=dim, depth=CANONICAL["depth"], heads=heads,
                  d_cross=img[0] * img[1])
    seq_len = 1 + len(cats) + ncont + CANONICAL["seq_length"]
    jamba = None
    for name, make, scans in (
            ("jamba", lambda: CrossJambaBoth(cats, ncont, **common),
             JAMBA_SCANS),
            ("transformer", lambda: CrossTransformerBoth(
                cats, ncont, dim_head=dim // heads, **common), 0)):
        cpu = materialized(make, seed=3).eval()
        gpu = copy.deepcopy(cpu).cuda()
        with torch.inference_mode():
            want = cpu(*inputs)
            k2.launches = 0
            got = gpu(*(t.cuda() for t in inputs[:3]),
                      [v.cuda() for v in inputs[3]])
            torch.cuda.synchronize()
        launched = k2.launches
        err, rel = rel_err(got.cpu(), want)
        log(f"mixer parity {name} head (L {seq_len}, dim {dim}, depth "
            f"{CANONICAL['depth']}) f32: "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-3); K2 launches "
            f"{launched}; {sum(p.numel() for p in cpu.parameters())} "
            f"parameters")
        if not (torch.isfinite(got).all() and rel <= 1e-3):
            raise AssertionError(f"{name} head: card and CPU disagree")
        if launched != scans:
            raise AssertionError(f"{name} head: {launched} K2 launches, "
                                 f"expected {scans}")
        if name == "jamba":
            jamba = gpu
        else:
            del gpu
        del cpu
    return jamba, inputs


def check_recurrent_step(jamba_head, inputs) -> None:
    """Phase 13(d): the canonical Jamba stack (the head of 13(a)) and a
    6-layer Mamba of width 512, stepped token by token over the 53 tokens
    of the head's input on the card in f32, equal their sequence forward
    within rel 1e-4; ``generate`` of a ``JambaLM`` at that width (vocab
    64) with ``top_k=1`` gives the tokens of a greedy argmax over the
    forward's logits."""
    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM, generate
    from gfe_mamba_torch.models.mamba import Mamba, MambaConfig

    dim, depth = CANONICAL["dim"], CANONICAL["depth"]
    x_cat, x_num, feature, _ = inputs
    with torch.inference_mode():
        seq = torch.cat([jamba_head.embed(x_cat.cuda(), x_num.cuda()),
                         feature.cuda()], dim=1)
    mamba = materialized(lambda: Mamba(MambaConfig(d_model=dim,
                                                   n_layers=depth)),
                         seed=4).cuda()
    stacks = (("Jamba (12 layers)", jamba_head.transformer,
               lambda x: jamba_head.transformer(x)[0], lambda t: t[:, None],
               lambda y: y[:, 0]),
              ("Mamba (6 layers)", mamba, mamba, lambda t: t,
               lambda y: y))
    for name, stack, forward, token, out in stacks:
        with torch.inference_mode():
            full = forward(seq)
            caches, steps = stack.init_cache(seq.shape[0]), []
            t = time.perf_counter()
            for i in range(seq.shape[1]):
                y, caches = stack.step(token(seq[:, i]), caches)
                steps.append(out(y))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        err, rel = rel_err(torch.stack(steps, dim=1), full)
        log(f"recurrent step {name}: {seq.shape[1]} steps in "
            f"{dt * 1e3:.1f} ms against the forward over {tuple(seq.shape)} "
            f"f32: max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"{name}: steps disagree with the forward")
    del mamba
    cfg = JambaConfig(d_model=dim, n_layers=2 * depth, mlp_size=2 * dim,
                      num_attention_heads=CANONICAL["heads"], vocab_size=64)
    lm = materialized(lambda: JambaLM(cfg), seed=5).cuda()
    prompt = torch.randint(0, 64, (2, 8),
                           generator=torch.Generator().manual_seed(6)).cuda()
    t = time.perf_counter()
    tokens = generate(lm, prompt, 8,
                      torch.Generator(device="cuda").manual_seed(7), top_k=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    with torch.inference_mode():
        greedy = lm(tokens)[0][:, prompt.shape[1] - 1:-1].argmax(-1)
    log(f"JambaLM.generate top_k=1 (d_model {dim}, 12 layers, vocab 64): "
        f"8 prompt + 8 new tokens in {dt * 1e3:.1f} ms; tokens "
        f"{tokens[:, 8:].tolist()}, greedy argmax of the forward "
        f"{greedy.tolist()}")
    if not torch.equal(greedy, tokens[:, prompt.shape[1]:]):
        raise AssertionError("generate(top_k=1) is not greedy")
    del lm
    torch.cuda.empty_cache()


def drive_other_mixer_clis(card: str, root: str, phase12: dict) -> None:
    """Phase 13(e): ``classify_mamba`` with ``mixer: 'jamba'`` on phase 12's
    tree and Stage-1 npz (1 epoch, batch 2, bf16), ``test_mamba`` on its
    checkpoint (the checks of :func:`stage2_then_evaluation`), then
    ``ft_table`` for 2 epochs on the synthetic CSV (batch 2), whose
    printed lines must have the JAX script's form; K2 and K4 each
    launch."""
    import contextlib
    import io
    import re

    from gfe_mamba_torch.cli import ft_table
    from gfe_mamba_torch.ops.cuda import selective_scan as k2

    configs = {name: dict(phase12["configs"][name], mixer="jamba",
                          project_dir=os.path.join(root, "w",
                                                   f"jamba_{name}"))
               for name in ("cls", "test")}
    torch.cuda.synchronize()
    k2.launches = k2.bwd_launches = 0
    walls = {}
    stage2 = stage2_then_evaluation(root, configs, "jamba CLI",
                                    phase12["g_end"], walls)
    counts = dict(K2=k2.launches, K4=k2.bwd_launches)

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = ft_table.main(ft_table.parse_args(
            ["--table_path", phase12["csv"], "--epochs", "2", "--batch",
             "2", "--log_every", "1", "--device", "cuda"]))
    torch.cuda.synchronize()
    walls["ft_table"] = time.perf_counter() - t
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"  ft_table: {line}")
    form = re.compile(r"^epoch (\d+): loss=\d+\.\d{4} acc=\d\.\d{4} "
                      r"f1=\d\.\d{4} mcc=-?\d\.\d{4}$")
    if [getattr(form.match(l), "group", lambda _: None)(1)
            for l in lines] != ["1", "2"] \
            or next(run["model"].parameters()).device.type != "cuda":
        raise AssertionError(f"ft_table printed {lines!r}")
    for name, wall in walls.items():
        log(f"jamba CLI phase: {name} {wall:.1f} s wall [{card}]")
    log(f"jamba CLI phase: Stage-2 steps "
        f"{['%.1f' % v for v in stage2['step_ms']]} ms, loader wait "
        f"{stage2['wait_ms']:.1f} ms per batch; classifier "
        f"{stage2['classifier_params']} parameters; ft_table "
        f"{len(run['train_rows'])} train / {len(run['test_rows'])} test "
        f"rows; launches {counts} [{card}]")
    missing = [name for name, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"{missing} never launched in the jamba CLI "
                             f"phase")


def drive_other_mixers(card: str, root: str, phase12: dict) -> dict:
    """Phase 13: the Jamba and transformer heads.  Returns the K2
    launches of the 3 Jamba requests and the K4 launches of the 3 Jamba
    Stage-2 steps."""
    t0 = time.perf_counter()
    jamba_head, inputs = check_other_heads_parity()
    check_recurrent_step(jamba_head, inputs)
    del jamba_head
    torch.cuda.empty_cache()
    _, k2_jamba, jamba_ms = serve_canonical(card, "jamba", JAMBA_SCANS)
    _, k2_none, transformer_ms = serve_canonical(card, "transformer", 0)
    stage2 = train_stage2_canonical(card, "jamba", JAMBA_SCANS)
    drive_other_mixer_clis(card, root, phase12)
    log(f"phase 13: jamba ms/request {jamba_ms}, transformer ms/request "
        f"{transformer_ms}, jamba Stage-2 ms/step {stage2['step_ms']}; "
        f"{time.perf_counter() - t0:.1f} s of wall [{card}]")
    return dict(k2=k2_jamba, k4=stage2["k4"])


def _adam_start(run: dict, player: str, name: str, lr: float):
    """The weights Adam's first step started from, read back from the
    step's result: p + lr m / (|m| + 1e-9) (its update is lr m_hat /
    (sqrt(v_hat) + 1e-8), with m_hat = 10 m and sqrt(v_hat) = |10 m|)."""
    m = run["moments"][player][name].float()
    return run["params"][player][name].float() + lr * m / (m.abs() + 1e-9)


def compare_dp(tag: str, dp: dict, one: dict, lrs: dict) -> None:
    """Phase 14(a)'s check of rank 0's step against one process stepping
    the global batch from the same weights, both bf16 on the card.  The
    per-sample forwards are the same work; what differs is the batch the
    card's GEMMs and K3 sum over and the order of the f32 gradient sums,
    so: the logged losses within 1e-2 relative (bf16 rounding); Adam's
    first moments (0.1 x the clipped gradient) within 5e-2 of their norm
    over each player's whole set of tensors (a missing gradient average,
    each rank on its own volume, reads 0.5 or more); every parameter
    within 2 lr of the reference's (Adam's first step moves an entry by
    about lr x sign(g), and a gradient near 0 may take either sign); and
    each run's update elementwise against its own moments: Adam's first
    step takes p0 - lr m / (|m| + 1e-9), so p + lr m / (|m| + 1e-9), the
    weights both runs started from, agrees between them within 1e-3 lr +
    2 f32 ulps of p.  A skipped, sign-flipped or rescaled update fails
    that, where the 2 lr bound alone cannot."""
    for key, want in one["logs"][0].items():
        got = dp["logs"][0][key]
        rel = abs(got - want) / max(abs(want), 1e-6)
        log(f"{tag} {key}: two ranks {got:.7g}, one process {want:.7g}, "
            f"rel {rel:.3e}")
        if key == "skipped" and got != want or not rel <= 1e-2:
            raise AssertionError(f"{tag}: {key} differs")
    for player, moments in one["moments"].items():
        got = dp["moments"][player]
        diff = sum(float((got[k].float() - v.float()).square().sum())
                   for k, v in moments.items())
        norm = sum(float(v.float().square().sum()) for v in moments.values())
        worst = max(((got[k].float() - v.float()).norm().item()
                     / max(v.float().norm().item(), 1e-12), k)
                    for k, v in moments.items())
        rel = math.sqrt(diff / max(norm, 1e-30))
        log(f"{tag} {player}: Adam first moments rel-to-norm {rel:.3e} over "
            f"{len(moments)} tensors (worst tensor {worst[0]:.3e}, "
            f"{worst[1]})")
        if not rel <= 5e-2:
            raise AssertionError(f"{tag}: {player}'s gradients differ")
    for player, state in one["params"].items():
        lr, eps = lrs[player], torch.finfo(torch.float32).eps
        err = max(float((dp["params"][player][k].float() - v.float())
                        .abs().max()) for k, v in state.items()
                  if v.is_floating_point())
        start = max(float(((_adam_start(dp, player, k, lr)
                            - _adam_start(one, player, k, lr)).abs()
                           - 2 * eps * state[k].float().abs()).max())
                    for k in one["moments"][player])
        log(f"{tag} {player}: parameters max |two ranks - one process| "
            f"{err:.3e} (bound 2 lr = {2 * lr:.1e}); the weights each "
            f"run's update started from differ by {start:.3e} over 2 ulps "
            f"(bound 1e-3 lr = {1e-3 * lr:.1e})")
        if not err <= 2.0001 * lr or not start <= 1e-3 * lr:
            raise AssertionError(f"{tag}: {player}'s parameters differ")


def dp_ranks(card: str) -> tuple:
    """Phase 14(a): two gloo ranks on the one card at the canonical width
    (160x160x96, bf16, f_maps 64/128/256, dim 512, depth 6), each at batch
    1 (``parallel/dryrun.py::launch``, ``testing.dp_steps``): one Stage-2
    step (Mamba head) and one Stage-1 step (adv_on 1), dropout off (each
    rank draws its own masks).  Returns the jobs and each rank's
    report."""
    import numpy as np

    from gfe_mamba_torch import testing
    from gfe_mamba_torch.parallel.dryrun import launch

    rs = np.random.RandomState(14)
    jobs = [
        dict(name="stage2", stage=2, build=dict(img_size=IMG, seed=0,
                                                cross_ff_dropout=0.0,
                                                **CANONICAL),
             trainer={}, keys=("mri", "x_cat", "x_num", "labels"),
             keep_rank=0, time_allreduce=True, batches=[dict(
                 mri=rs.randn(2, *IMG, 1).astype(np.float32),
                 x_cat=rs.randint(0, 6, (2, 8)),
                 x_num=rs.randn(2, 40).astype(np.float32),
                 labels=np.asarray([1.0, 0.0], np.float32))]),
        dict(name="stage1", stage=1, build=dict(
            img_size=IMG, seed=0, vit_dropout=0.0, vit_emb_dropout=0.0),
             disc=(3, 32), fake_3d_ratio=0.25, trainer={},
             keys=("mri", "pet"), extra=(1.0,), keep_rank=0,
             time_allreduce=True,
             batches=[dict(mri=rs.randn(2, *IMG, 1).astype(np.float32),
                           pet=rs.randn(2, *IMG, 1).astype(np.float32))])]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="gfe_dp_") as out:
        t = time.perf_counter()
        launch(testing.dp_steps, 2, (out, dict(device="cuda:0", jobs=jobs)),
               device="cuda:0", backend="gloo", timeout_s=600)
        wall = time.perf_counter() - t
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    log(f"phase 14(a): two gloo ranks on one card took {wall:.1f} s of wall")
    return jobs, ranks


def check_dp(card: str, jobs: list, ranks: list) -> dict:
    """Phase 14(a)'s checks: this process steps each job's global batch of
    2 from the same weights (``testing.run_job``) and :func:`compare_dp`
    holds rank 0 to it; both ranks' parameters bitwise equal (digests of
    every tensor); each rank launches K1, K2 and K4 (Stage 2) and K1 and
    K3 (Stage 1).  Gloo stages its all-reduces through the host, so the
    step times and peak memory logged describe that, not NCCL data
    parallelism.  Returns rank 0's launches."""
    from gfe_mamba_torch import testing

    want = {"stage2": ("K1", "K2", "K4"), "stage1": ("K1", "K3")}
    for job in jobs:
        name = job["name"]
        for r, rank in enumerate(ranks):
            run = rank[name]
            log(f"phase 14(a) {name} rank {r}: step {run['step_ms'][0]:.1f} "
                f"ms (first step, gloo through the host on one card, not "
                f"NCCL data parallelism), peak "
                f"{run['peak_bytes'] / 2**30:.2f} GiB, launches "
                f"{run['launches']}, logs {run['logs'][0]} [{card}]")
            ar = run["allreduce"]
            log(f"phase 14(a) {name} rank {r}: the gradient average alone "
                f"(gloo through the host) {ar['bytes']} bytes, "
                f"{['%.1f' % v for v in ar['ms']]} ms, "
                f"{ar['bytes'] / (min(ar['ms']) * 1e6):.2f} GB/s [{card}]")
            missing = [k for k in want[name] if run["launches"][k] <= 0]
            if missing:
                raise AssertionError(f"phase 14(a) {name}: rank {r} never "
                                     f"launched {missing}")
        if ranks[0][name]["digests"] != ranks[1][name]["digests"]:
            raise AssertionError(f"phase 14(a) {name}: the ranks' "
                                 f"parameters differ")
        log(f"phase 14(a) {name}: both ranks' {len(ranks[0][name]['digests'])}"
            f" tensors bitwise equal")
        t = time.perf_counter()
        one = testing.run_job({k: v for k, v in job.items()
                               if k != "keep_rank"}, None,
                              torch.device("cuda"))
        torch.cuda.synchronize()
        log(f"phase 14(a) {name}: one process, global batch 2, "
            f"{time.perf_counter() - t:.1f} s of wall (build included)")
        lrs = {"model": 1e-4, "generator": 1e-4, "discriminator": 5e-4}
        compare_dp(f"phase 14(a) {name}", ranks[0][name], one, lrs)
        del one
        torch.cuda.empty_cache()
    l2, l1 = ranks[0]["stage2"]["launches"], ranks[0]["stage1"]["launches"]
    return dict(K1=l2["K1"] + l1["K1"], K2=l2["K2"], K3=l1["K3"],
                K4=l2["K4"])


def start(args: list, cwd: str) -> tuple:
    """``python <args>`` started in ``cwd`` with the repository on the
    path, its output to a file; ``(process, start time, output file)``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tempfile.TemporaryFile(mode="w+")
    return (subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                             stdout=out, stderr=subprocess.STDOUT,
                             text=True), time.perf_counter(), out)


def finish_all(started: dict, card: str, timeout: float = 600) -> dict:
    """Wait for every process :func:`start` began; log each one's wall
    and return each one's output.  One that exits non-zero or outlives
    ``timeout`` fails the phase (the others are killed)."""
    walls, t0 = {}, time.perf_counter()
    try:
        while len(walls) < len(started):
            for name, (proc, t, _) in started.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - t
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"phase 14: {sorted(set(started) - set(walls))}"
                                     f" ran past {timeout} s")
            time.sleep(0.2)
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = {}
    for name, (proc, _, f) in started.items():
        f.seek(0)
        outs[name] = f.read()
        f.close()
        log(f"phase 14: {name} {walls[name]:.1f} s of wall, run beside "
            f"the others [{card}]")
        if proc.returncode != 0:
            log(outs[name][-6000:])
            raise AssertionError(f"phase 14: {name} exited "
                                 f"{proc.returncode}")
    return outs


def start_dryrun() -> tuple:
    """Phase 14(b): the dry run (``python -m gfe_mamba_torch.parallel.
    dryrun``) at 2 processes on the card over gloo with a model axis of
    2, so its tensor- and expert-parallel projections run on CUDA
    tensors; widths 8/16/32 (K1 takes multiples of 8)."""
    return start(["-m", "gfe_mamba_torch.parallel.dryrun", "--procs", "2",
                  "--model", "2", "--device", "cuda:0", "--backend", "gloo",
                  "--f_maps", "8,16,32", "--timeout", "300"], REPO)


def check_dryrun(out: str) -> None:
    for line in out.strip().splitlines():
        log(f"  {line}")
    if "dryrun(2): ok" not in out or out.count(" ok\n") < 2:
        raise AssertionError("phase 14(b): the dry run did not pass")


def torchrun_configs(root: str, phase12: dict) -> dict:
    """Phase 12's Stage-1 and Stage-2 configs with ``async_ckpt: true``
    and a project directory of their own."""
    w14 = os.path.join(root, "w14")
    return dict(
        gan=dict(phase12["configs"]["gan"], async_ckpt=True,
                 project_dir=w14),
        cls=dict(phase12["configs"]["cls"], async_ckpt=True,
                 project_dir=os.path.join(w14, "classifier")))


def start_torchrun_clis(root: str, configs: dict) -> dict:
    """Phase 14(c): ``torchrun --nproc_per_node 1`` (NCCL at world 1) of
    the Stage-1 and Stage-2 CLIs, both started (Stage 2 loads phase 12's
    Stage-1 npz, so neither waits for the other)."""
    out = {}
    for name, module in (("gan", "main_gan_vit"), ("cls", "classify_mamba")):
        path = os.path.join(root, f"p14_{name}.yaml")
        with open(path, "w") as f:
            f.write(yaml_text(configs[name]))
        out[f"torchrun {module}"] = start(
            ["-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", f"gfe_mamba_torch.cli.{module}",
             "--config_path", path], root)
    return out


def check_torchrun_clis(root: str, configs: dict, phase12: dict) -> None:
    """Phase 14(c)'s checks: the npz files the torchrun runs wrote are
    bitwise phase 12's, and ``AutoResume`` over the async manager's
    snapshots restores Stage 1's last state (phase 12's generator,
    bitwise)."""
    import numpy as np

    from gfe_mamba_torch.training.resilience import AutoResume

    w14 = configs["gan"]["project_dir"]
    cls_dir = configs["cls"]["project_dir"]
    pairs = [("model_save/model.npz", os.path.join(root, "w"), w14)] + [
        (f"model_current/{f}", phase12["configs"]["cls"]["project_dir"],
         cls_dir) for f in ("model_current.npz", "ft_model_current.npz")]
    unequal = []
    for rel, plain, ranked in pairs:
        a = np.load(os.path.join(only_run(plain), rel))
        b = np.load(os.path.join(only_run(ranked), rel))
        differ = sorted(k for k in a.files
                        if k not in b.files or not np.array_equal(a[k], b[k]))
        log(f"phase 14(c): {rel}: {len(a.files) - len(differ)} of "
            f"{len(a.files)} arrays bitwise phase 12's" + "".join(
                f"; {k} max |diff| "
                f"{float(np.abs(a[k] - b[k]).max()) if k in b.files else 'missing'}"
                for k in differ[:5]))
        if differ or sorted(a.files) != sorted(b.files):
            unequal.append(rel)
    if unequal:
        raise AssertionError(f"phase 14(c): {unequal} under torchrun are "
                             f"not phase 12's, bitwise")
    steps = sorted(os.listdir(os.path.join(only_run(w14), "model_save")))
    auto = AutoResume(os.path.join(w14, "autoresume_main_gan_vit"),
                      async_save=True)
    step, payload = auto.restore_latest()
    if payload is None or payload["epoch"] != 1 or not states_equal(
            payload["gan"]["generator"], phase12["g_end"]):
        raise AssertionError(f"phase 14(c): AutoResume over the async "
                             f"manager restored step {step}, not Stage 1's "
                             f"last state")
    log(f"phase 14(c): model_save holds {steps}; AutoResume over the async "
        f"manager restores step {step}, epoch {payload['epoch']}, the "
        f"generator bitwise phase 12's last state")


def seg_model(cfg: dict, seed: int = 0):
    """``get_model(cfg)`` on the CPU (weights drawn from ``seed``, eval)."""
    from gfe_mamba_torch.models.unet3d import get_model
    return get_model(cfg, seed=seed)


def seg_parity(card: str) -> None:
    """Phase 15(a): each family's logits on the card against the CPU, same
    weights, f32, TF32 off; UNet3D and ResidualUNet3D at full width must
    launch K1 13 and 18 times per forward."""
    from gfe_mamba_torch.ops.cuda import conv3d as k1

    for cfg, shape in SEG_PARITY_CASES:
        cfg = dict(cfg, is_segmentation=False)     # logits, not sigmoid
        model = seg_model(cfg, seed=5)
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(6))
        t = time.perf_counter()
        with torch.no_grad():
            want = model(x)
        cpu_s = time.perf_counter() - t
        model.to("cuda")
        with torch.no_grad():
            before = k1.launches
            got = model(x.to("cuda"))
            torch.cuda.synchronize()
        launches = k1.launches - before
        err, rel = rel_err(got, want)
        log(f"phase 15(a) {cfg['name']} {list(shape)}: card vs CPU "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-4); K1 "
            f"{launches} launches per forward; CPU forward {cpu_s:.1f} s")
        if not rel <= 1e-4:
            raise AssertionError(f"phase 15(a) {cfg['name']}: card and CPU "
                                 f"differ: rel {rel}")
        want_k1 = SEG_FORWARD_K1.get(cfg["name"])
        if want_k1 is not None and launches != want_k1:
            raise AssertionError(f"phase 15(a) {cfg['name']}: {launches} K1 "
                                 f"launches per forward, expected {want_k1}")
        if cfg["name"] == "UNet2D" and launches:
            raise AssertionError("phase 15(a) UNet2D launched K1")
        del model, got, want
    torch.cuda.empty_cache()


def seg_step_parity(card: str) -> None:
    """Phase 15(f): one ``UNetTrainer`` step (BCEDice, Adam) of UNet3D at
    full width on a 32x64x64 patch, from the same weights, on the CPU
    (plain versions), on the card (K1, K1-dz, K3) and, as a witness, on
    the card with the plain convs in place of the kernels.  The step is
    held on a model whose every derivative is continuous, so that only
    rounding separates the runs: order gce (relu's derivative jumps at 0,
    and a change in rounding flips a few of its pre-activations, which
    moves some gradients by 1e-2 of their max), and the encoders' pooling
    set to average.  Max pooling's argmax flips where two candidates sit
    within rounding of each other: on the H100, one window of 262,144
    took another argmax between the kernels' forward and the witness's
    (which agree within 2.1e-6) and moved a conv weight's gradient by
    1.0e-2 of its max; with max pooling the card's gradients also sat
    7.3e-3 from the CPU's.  The kernels' step is held to the witness
    within 1e-4 (each gradient against its largest entry and its norm,
    and the loss), and to the CPU as in phase 9: the loss within 1e-4,
    the gradients within twice the witness's worst error (at least
    1e-3)."""
    from gfe_mamba_torch.ops.blocks import Encoder
    from gfe_mamba_torch.segmentation.trainer import UNetTrainer

    config = {"loss": {"name": "BCEDiceLoss"},
              "eval_metric": {"name": "DiceCoefficient"},
              "optimizer": {"name": "Adam", "learning_rate": 1e-4}}
    gen = torch.Generator().manual_seed(16)
    raw = torch.randn(1, *SEG_PARITY_CASES[0][1][1:], generator=gen)
    label = (torch.rand(raw.shape, generator=gen) > 0.5).float()
    tag = f"phase 15(f) UNet3D gce {list(raw.shape)} step"
    t = time.perf_counter()
    model = seg_model(dict(SEG_UNET3D, layer_order="gce"), seed=17)
    for module in model.modules():
        if isinstance(module, Encoder):
            module.pool_type = "avg"
    runs = (("cpu", model, contextlib.nullcontext),
            ("cuda", copy.deepcopy(model), contextlib.nullcontext),
            ("cuda", copy.deepcopy(model), plain_convs_on_card))
    trainers, logs = [], []
    with tempfile.TemporaryDirectory(prefix="gfe_seg_step_") as ckpt:
        for device, m, convs in runs:
            tr = UNetTrainer(m, config, ckpt, device=device)
            tr.init_state(0)
            with convs():
                logs.append({"loss": tr.train_step(raw.to(tr.device),
                                                   label.to(tr.device))})
            trainers.append(tr)
    torch.cuda.synchronize()

    def errors(a, b):
        return grad_errors([("U", a.optimizer,
                             dict(a.model.named_parameters()), b.optimizer,
                             dict(b.model.named_parameters()))])

    on_cpu, kernels, witness = trainers
    check_losses(f"{tag} kernels vs witness", logs[2], logs[1], tol=1e-4)
    check_grads(f"{tag} kernels vs witness, both on the card",
                errors(witness, kernels), 1e-4, 1e-4)
    check_losses(f"{tag} kernels vs CPU", logs[0], logs[1], tol=1e-4)
    plain_max, plain_norm = report_grads(
        f"{tag} witness: plain convs on the card vs CPU",
        errors(on_cpu, witness), top=3)
    check_grads(f"{tag} kernels vs CPU", errors(on_cpu, kernels),
                max(1e-3, 2 * plain_max), max(1e-3, 2 * plain_norm))
    log(f"{tag} parity done in {time.perf_counter() - t:.1f} s [{card}]")
    del model, runs, trainers, on_cpu, kernels, witness
    torch.cuda.empty_cache()


def seg_check_kernels(gen) -> None:
    """Phase 15(d): K1 (forward with the folded GN and relu, and as dz with
    flipped weights) and K3 (f32, with the GN affine) against their plain
    versions at the segmentation widths; the stem's C_in = 1 is refused by
    K1 and ruled onto cuDNN."""
    from gfe_mamba_torch.ops.blocks import SingleConv, k1_eligible
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    for C, F in SEG_CHECK_WIDTHS:
        x, w, _, a, s, _ = conv_inputs(gen, SEG_CHECK_SHAPE, C, F,
                                       torch.float32, False)
        got = kc.conv3x3x3_cuda(x, w, None, a, s, None, "relu")
        want = kc.conv3x3x3_plain(x, w, None, a, s, None, "relu")
        g1 = torch.randn(*SEG_CHECK_SHAPE, F, generator=gen, device="cuda")
        wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        dz, dz_want = kc.conv3x3x3_cuda(g1, wf), kc.conv3x3x3_plain(g1, wf)
        dw = kc.conv3x3x3_dw_cuda(x, g1, a, s)
        dw_want = kc.conv3x3x3_dw_plain(x, g1, a, s)
        torch.cuda.synchronize()
        for name, pair in (("K1", (got, want)), ("K1-dz", (dz, dz_want)),
                           ("K3", (dw, dw_want))):
            err, rel = rel_err(*pair)
            log(f"phase 15(d) {name} check {list(SEG_CHECK_SHAPE)}x{C}->{F} "
                f"f32: max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-4)")
            if not rel <= 1e-4:
                raise AssertionError(f"phase 15(d) {name} at {C}->{F} "
                                     f"disagrees with its plain version: "
                                     f"rel {rel}")
        del x, w, a, s, g1, wf, got, want, dz, dz_want, dw, dw_want
    x = torch.randn(1, 8, 8, 8, 1, generator=gen, device="cuda")
    w = torch.randn(3, 3, 3, 1, 32, generator=gen, device="cuda")
    try:
        kc.conv3x3x3_cuda(x, w)
    except ValueError as exc:
        log(f"phase 15(d) K1 refuses the stem's C=1 -> F=32: {exc}")
    else:
        raise AssertionError("K1 took a C_in = 1 conv")
    stem = SingleConv(1, 32, "gcr", 8)
    if k1_eligible(3, 3, 1, 1, 32) or stem.fused:
        raise AssertionError("the conv rule sends the stem to K1")
    log("phase 15(d) the conv rule sends the stem (1 -> 32) to cuDNN")


def seg_conv_specs(model, x) -> list:
    """The input shape, output width and GN/act flags of every K1 conv of
    ``model``'s forward on ``x``, from forward pre-hooks."""
    from gfe_mamba_torch.ops.blocks import SingleConv

    specs, hooks = [], []
    for mod in model.modules():
        if isinstance(mod, SingleConv) and mod.fused:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: specs.append(
                    (tuple(args[0].shape), m.conv.weight.shape[0]))))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return specs


def seg_times(card: str, gen) -> dict:
    """Phase 15(e): a UNet3D forward at full width on one patch (batch 1),
    and per forward its 13 K1 convs, their plain versions, cuDNN's f32
    conv on the same convs (TF32 off) and the bound; per training step
    the same convs as K1-dz against cuDNN's dgrad and as K3 against
    cuDNN's wgrad.  Bounds: f32 operations over the CUDA-core peak, or
    bytes (each input read once, each output written once) over HBM.
    At each of the 13 shapes K1, K1-dz and K3 are first held against
    their plain versions on the same inputs (1e-4 of the largest entry);
    the worst errors go into the kernels line.  Each kernel's rate is
    printed as TFLOP/s and as its share of the f32 peak (PEAK_F32)."""
    from gfe_mamba_torch.ops.cuda import conv3d as kc

    model = seg_model(SEG_UNET3D).to("cuda")
    x = torch.randn(1, *SEG_PATCH, 1, generator=gen, device="cuda")
    specs = seg_conv_specs(model, x)
    if len(specs) != SEG_FORWARD_K1["UNet3D"]:
        raise AssertionError(f"UNet3D has {len(specs)} K1 convs")
    with torch.no_grad():
        forward = time_ms(lambda: model(x), reps=3)
    del model
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    step = dict(dz_ms=0.0, dz_library_ms=0.0, dz_bound_ms=0.0, dw_ms=0.0,
                dw_plain_ms=0.0, dw_library_ms=0.0, dw_bound_ms=0.0)
    flops_total = 0
    errors = {"K1": (0.0, 0.0), "K1-dz": (0.0, 0.0), "K3": (0.0, 0.0)}
    for shape, F in specs:
        C = shape[-1]
        xi, w, _, a, s, _ = conv_inputs(gen, shape[:-1], C, F,
                                        torch.float32, False)
        g1 = torch.randn(*shape[:-1], F, generator=gen, device="cuda")
        wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        for name, kernel, plain in (
                ("K1", lambda: kc.conv3x3x3_cuda(xi, w, None, a, s, None,
                                                 "relu"),
                 lambda: kc.conv3x3x3_plain(xi, w, None, a, s, None,
                                            "relu")),
                ("K1-dz", lambda: kc.conv3x3x3_cuda(g1, wf),
                 lambda: kc.conv3x3x3_plain(g1, wf)),
                ("K3", lambda: kc.conv3x3x3_dw_cuda(xi, g1, a, s),
                 lambda: kc.conv3x3x3_dw_plain(xi, g1, a, s))):
            err, rel = rel_err(kernel(), plain())
            log(f"phase 15(e) {name} check {list(shape[:-1])}x{C}->{F} f32:"
                f" max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-4)")
            if not rel <= 1e-4:
                raise AssertionError(f"phase 15(e) {name} at "
                                     f"{list(shape[:-1])}x{C}->{F} disagrees "
                                     f"with its plain version: rel {rel}")
            errors[name] = tuple(map(max, errors[name], (err, rel)))
        zhat = kc.affine_in_dtype(xi, a, s)
        xc = zhat.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        vox = math.prod(shape[:-1])
        flops = 2 * vox * 27 * C * F
        flops_total += flops
        t_ops = flops / PEAK_F32
        fwd_bytes = 4 * (vox * (C + F) + 27 * C * F) + 8 * C
        fwd["bound_ms"] += max(t_ops, fwd_bytes / HBM_BYTES_PER_S) * 1e3
        ms = dict(
            k1=time_ms(lambda: kc.conv3x3x3_cuda(
                xi, w, None, a, s, None, "relu"), reps=3),
            plain=time_ms(lambda: kc.conv3x3x3_plain(
                xi, w, None, a, s, None, "relu"), reps=3),
            conv=time_ms(lambda: torch.nn.functional.conv3d(
                xc, wc, padding=1), reps=3),
            dz=time_ms(lambda: kc.conv3x3x3_cuda(g1, wf), reps=3),
            dgrad=time_ms(lambda: cudnn_conv_grad(zhat, w, g1, "x"), reps=3),
            k3=time_ms(lambda: kc.conv3x3x3_dw_cuda(xi, g1, a, s), reps=3),
            wgrad=time_ms(lambda: cudnn_conv_grad(zhat, w, g1, "w"), reps=3))
        fwd["ms"] += ms["k1"]
        fwd["plain_ms"] += ms["plain"]
        fwd["library_ms"] += ms["conv"]
        step["dz_ms"] += ms["dz"]
        step["dz_library_ms"] += ms["dgrad"]
        step["dw_ms"] += ms["k3"]
        step["dw_plain_ms"] += time_ms(lambda: kc.conv3x3x3_dw_plain(
            xi, g1, a, s), reps=1)
        step["dw_library_ms"] += ms["wgrad"]
        log(f"phase 15(e) time {list(shape[:-1])}x{C}->{F} f32: K1 "
            f"{ms['k1']:.3f} ms ({flops / ms['k1'] / 1e9:.1f} TFLOP/s), "
            f"plain {ms['plain']:.3f}, cuDNN conv {ms['conv']:.3f}; K1-dz "
            f"{ms['dz']:.3f} ({flops / ms['dz'] / 1e9:.1f} TFLOP/s), cuDNN "
            f"dgrad {ms['dgrad']:.3f}; K3 {ms['k3']:.3f} "
            f"({flops / ms['k3'] / 1e9:.1f} TFLOP/s), cuDNN wgrad "
            f"{ms['wgrad']:.3f}; bound {t_ops * 1e3:.3f} ms")
        # dz reads g1 and w and writes dz; dw reads x and g1 and writes dw
        step["dz_bound_ms"] += max(t_ops, fwd_bytes / HBM_BYTES_PER_S) * 1e3
        step["dw_bound_ms"] += max(t_ops, fwd_bytes / HBM_BYTES_PER_S) * 1e3
        del xi, w, a, s, g1, wf, zhat, xc, wc
    torch.cuda.empty_cache()
    # achieved rate over the 13 convs, and its share of the f32 peak
    for entry, key in ((fwd, "ms"), (step, "dz_ms"), (step, "dw_ms")):
        prefix = key[:-2]
        entry[f"{prefix}tflops"] = flops_total / entry[key] / 1e9
        entry[f"{prefix}f32_peak_share"] = \
            flops_total / entry[key] / 1e-3 / PEAK_F32
    log(f"phase 15(e) UNet3D forward {list(SEG_PATCH)} batch 1 f32: "
        f"{forward:.2f} ms; its 13 K1 convs {fwd['ms']:.2f} ms "
        f"({fwd['ms'] / forward:.1%}; {fwd['tflops']:.1f} TFLOP/s, "
        f"{fwd['f32_peak_share']:.1%} of the f32 peak), plain "
        f"{fwd['plain_ms']:.2f} ms, cuDNN f32 conv {fwd['library_ms']:.2f} "
        f"ms, bound {fwd['bound_ms']:.2f} ms [{card}]")
    log(f"phase 15(e) per training step (batch 1): K1-dz {step['dz_ms']:.2f}"
        f" ms ({step['dz_tflops']:.1f} TFLOP/s, "
        f"{step['dz_f32_peak_share']:.1%}; cuDNN dgrad "
        f"{step['dz_library_ms']:.2f}, bound {step['dz_bound_ms']:.2f}), K3 "
        f"{step['dw_ms']:.2f} ms ({step['dw_tflops']:.1f} TFLOP/s, "
        f"{step['dw_f32_peak_share']:.1%}; plain "
        f"{step['dw_plain_ms']:.2f}, cuDNN wgrad "
        f"{step['dw_library_ms']:.2f}, bound {step['dw_bound_ms']:.2f}) "
        f"[{card}]")
    for name, (err, rel) in errors.items():
        log(f"phase 15(e) {name} at the 13 path shapes: worst max_abs_err="
            f"{err:.3e}, worst rel={rel:.3e} (tol 1e-4)")
    return dict(forward_ms=forward, k1=fwd, step=step, errors=errors)


def seg_write_volume(path: str, shape, seed: int) -> None:
    """A smooth synthetic volume and its foreground label, written by
    ``data/h5.py`` (gzip-chunked)."""
    import numpy as np

    from gfe_mamba_torch.data import h5
    rng = np.random.RandomState(seed)
    coarse = rng.randn(*[max(2, n // 16) for n in shape]).astype(np.float32)
    raw = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=tuple(shape),
        mode="trilinear", align_corners=False)[0, 0].numpy()
    raw += 0.1 * rng.randn(*shape).astype(np.float32)
    h5.write(path, {"raw": raw, "label": (raw > 0).astype(np.uint8)})


def seg_config(root: str, **sections) -> str:
    """The nested YAML of a segmentation run over ``root``'s directories."""
    model = "\n".join(f"  {k}: {v}" for k, v in SEG_UNET3D.items())
    text = f"""manual_seed: 0
model:
{model}
model_path: {sections.get('model_path', root + '/ckpt/best_checkpoint')}
loss:
  name: BCEDiceLoss
eval_metric:
  name: DiceCoefficient
optimizer:
  name: Adam
  learning_rate: 1.0e-4
trainer:
  checkpoint_dir: {root}/ckpt
  max_num_iterations: 3
  max_num_epochs: 10
  validate_after_iters: 2
  log_after_iters: 1
loaders:
  batch_size: 1
  num_workers: 0
  train:
    file_paths: [{root}/train]
    slice_builder:
      patch_shape: {list(SEG_PATCH)}
      stride_shape: {list(SEG_PATCH)}
    transformer:
      - name: Standardize
  val:
    file_paths: [{root}/val]
    slice_builder:
      patch_shape: {list(SEG_PATCH)}
      stride_shape: {list(SEG_PATCH)}
  test:
    file_paths: [{sections.get('test', root + '/test')}]
    batch_size: {SEG_BATCH}
    slice_builder:
      patch_shape: {list(SEG_PATCH)}
      stride_shape: {list(SEG_STRIDE)}
"""
    path = os.path.join(root, f"{sections.get('name', 'seg')}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def seg_args(config: str, *overrides):
    import argparse
    return argparse.Namespace(config=config, override=list(overrides),
                              device="cuda")


def seg_predict_phase(card: str, root: str) -> dict:
    """Phase 15(b): ``seg_predict`` over a synthetic volume at full width
    (patches at batch 4) from a checkpoint of seeded weights; its file,
    read back by ``data/h5.py``, must equal ``sliding_window_predict``
    driven directly, and K1 must launch 13 times per forward."""
    import numpy as np

    from gfe_mamba_torch.cli import seg_predict
    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.segmentation.predictor import sliding_window_predict
    from gfe_mamba_torch.segmentation.slicers import SliceBuilder
    from gfe_mamba_torch.training.checkpoint import Checkpointer

    os.makedirs(f"{root}/big")
    seg_write_volume(f"{root}/big/volume.h5", SEG_VOLUME, 11)
    model = seg_model(SEG_UNET3D, seed=12)
    Checkpointer(f"{root}/seeded").save("weights", {
        "model": model.state_dict(), "num_iterations": 0,
        "best_eval_score": 0.0})
    config = seg_config(root, name="predict", test=f"{root}/big",
                        model_path=f"{root}/seeded/weights")
    before = k1.launches
    t = time.perf_counter()
    written = seg_predict.main(seg_args(config))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = k1.launches - before
    patches = len(SliceBuilder(SEG_VOLUME, SEG_PATCH, SEG_STRIDE))
    forwards = -(-patches // SEG_BATCH)
    got = h5.read(written[0], "predictions")
    model.to("cuda")

    @torch.no_grad()
    def fwd(x):
        return model(torch.from_numpy(x).to("cuda")).cpu().numpy()

    raw = h5.read(f"{root}/big/volume.h5", "raw")[..., None]
    want = np.moveaxis(sliding_window_predict(
        fwd, raw, SEG_PATCH, SEG_STRIDE, batch_size=SEG_BATCH), -1, 0)
    diff = float(np.abs(got - want).max())
    log(f"phase 15(b) seg_predict {list(SEG_VOLUME)}: {patches} patches in "
        f"{forwards} forwards of batch {SEG_BATCH}, {wall:.1f} s wall "
        f"[{card}]; K1 {launches} launches; file vs direct max |diff| "
        f"{diff:.3e}; predictions in [{got.min():.3f}, {got.max():.3f}]")
    if got.shape != (1, *SEG_VOLUME) or not np.isfinite(got).all():
        raise AssertionError(f"phase 15(b): predictions {got.shape}")
    if diff > 1e-6:
        raise AssertionError(f"phase 15(b): the file differs from the "
                             f"direct prediction by {diff}")
    if launches != SEG_FORWARD_K1["UNet3D"] * forwards:
        raise AssertionError(f"phase 15(b): {launches} K1 launches, "
                             f"expected 13 x {forwards}")
    del model
    torch.cuda.empty_cache()
    return dict(wall_s=wall, forwards=forwards)


def seg_train_phase(card: str, root: str) -> dict:
    """Phase 15(c): ``seg_train`` of UNet3D at full width, batch 1: 3 steps
    with one validation and both checkpoints, a resume from the last one
    to step 4, then ``seg_predict`` from the best one.  Each step must
    launch K1 13 times in the forward and 13 times as dz, and K3 13 times
    (on its f32 variant)."""
    import numpy as np

    from gfe_mamba_torch.cli import seg_predict, seg_train
    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.segmentation import trainer as seg_trainer
    from gfe_mamba_torch.training.checkpoint import Checkpointer

    for phase, shape, seed in (("train", (SEG_PATCH[0], SEG_PATCH[1],
                                          2 * SEG_PATCH[2]), 21),
                               ("val", SEG_PATCH, 22), ("test", SEG_PATCH,
                                                        23)):
        os.makedirs(f"{root}/{phase}")
        seg_write_volume(f"{root}/{phase}/v.h5", shape, seed)
    config = seg_config(root)
    steps = []
    original = seg_trainer.UNetTrainer.train_step

    def counted(self, raw, label):
        at_forward_end = []
        hook = self.model.register_forward_hook(
            lambda *_: at_forward_end.append(k1.launches))
        before = (k1.launches, k1.dw_launches, k1.dw_fma_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            loss = original(self, raw, label)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        steps.append(dict(
            ms=(time.perf_counter() - t) * 1e3, loss=loss,
            forward=at_forward_end[0] - before[0],
            dz=k1.launches - at_forward_end[0],
            k3=k1.dw_launches - before[1], k3_f32=k1.dw_fma_launches
            - before[2]))
        return loss

    seg_trainer.UNetTrainer.train_step = counted
    try:
        t = time.perf_counter()
        first = seg_train.main(seg_args(config))
        first_wall = time.perf_counter() - t
        resumed = seg_train.main(seg_args(
            config, "trainer.resume=true", "trainer.max_num_iterations=4"))
    finally:
        seg_trainer.UNetTrainer.train_step = original
    for i, st in enumerate(steps):
        log(f"phase 15(c) seg_train step {i + 1}: {st['ms']:.1f} ms "
            f"[{card}], loss {st['loss']:.5f}; K1 {st['forward']} forward "
            f"+ {st['dz']} dz, K3 {st['k3']} ({st['k3_f32']} f32)")
        if (st["forward"], st["dz"], st["k3"], st["k3_f32"]) != \
                (13, 13, 13, 13) or not math.isfinite(st["loss"]):
            raise AssertionError(f"phase 15(c) step {i + 1}: {st}")
    ckpt = Checkpointer(f"{root}/ckpt")
    last = ckpt.restore("last_checkpoint", map_location="cpu")
    if (len(steps), first.num_iterations, resumed.num_iterations,
            last["num_iterations"]) != (5, 3, 4, 4) \
            or not ckpt.exists("best_checkpoint"):
        raise AssertionError(f"phase 15(c): {len(steps)} steps, iterations "
                             f"{first.num_iterations} then "
                             f"{resumed.num_iterations}, last checkpoint at "
                             f"{last['num_iterations']}")
    written = seg_predict.main(seg_args(config))
    pred = h5.read(written[0], "predictions")
    if pred.shape != (1, *SEG_PATCH) or not np.isfinite(pred).all() \
            or pred.min() < 0 or pred.max() > 1:
        raise AssertionError(f"phase 15(c): seg_predict from the best "
                             f"checkpoint gave {pred.shape}")
    log(f"phase 15(c) seg_train: first run (3 steps, 1 validation) "
        f"{first_wall:.1f} s wall, resumed at iteration 2 to 4; best score "
        f"{resumed.best_eval_score:.4f}; seg_predict from the best "
        f"checkpoint {list(pred.shape)} [{card}]")
    return dict(step_ms=[st["ms"] for st in steps])


def drive_segmentation(card: str) -> dict:
    """Phase 15: the segmentation family on the card, f32, TF32 off."""
    from gfe_mamba_torch.ops.cuda import conv3d as k1

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    with tf32_settings(False, False):
        seg_parity(card)
        seg_step_parity(card)
        seg_check_kernels(gen)
        times = seg_times(card, gen)
        with tempfile.TemporaryDirectory(prefix="gfe_seg_") as root:
            k1.launches = k1.dw_launches = 0
            k1.dw_mma_launches = k1.dw_fma_launches = 0
            predict = seg_predict_phase(card, root)
            train = seg_train_phase(card, root)
            launches = dict(K1=k1.launches, K3=k1.dw_launches)
    log(f"phase 15: seg_train ms/step {['%.1f' % v for v in train['step_ms']]}"
        f", seg_predict {predict['wall_s']:.1f} s wall; launches on the path "
        f"{launches}; {time.perf_counter() - t0:.1f} s of wall [{card}]")
    if not all(launches.values()):
        raise AssertionError(f"phase 15: {launches}: a kernel never "
                             f"launched on the segmentation path")
    return dict(launches=launches, times=times, train_step_ms=train["step_ms"],
                predict_wall_s=predict["wall_s"])


@contextlib.contextmanager
def tf32_settings(cudnn: bool, matmul: bool):
    """cuDNN's and cuBLAS's TF32 switches set for the block, then put
    back."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def drive_parallel(card: str, root: str, phase12: dict) -> dict:
    """Phase 14: the parallel layer on the card; returns rank 0's launches
    in 14(a)."""
    t0 = time.perf_counter()
    jobs, ranks = dp_ranks(card)
    # (b), the two runs of (c) and (a)'s one-process references are
    # independent: all at once on the card (their walls overlap)
    configs = torchrun_configs(root, phase12)
    procs = {"dry run": start_dryrun(),
             **start_torchrun_clis(root, configs)}
    try:
        launches = check_dp(card, jobs, ranks)
    except BaseException:
        for proc, _, _ in procs.values():
            proc.kill()
            proc.wait()
        raise
    outs = finish_all(procs, card)
    check_dryrun(outs["dry run"])
    check_torchrun_clis(root, configs, phase12)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s of wall [{card}]")
    return launches


# phase 16: the modules no main path builds, f32 with TF32 off.  (a) and
# (b) hold card against CPU at batch 1 on a reduced volume and time the
# forward at batch 4 on the canonical one
P16_BATCH = 4
P16_PARITY_VOLUME = (64, 64, 48)
# (c): Jamba-v0.1's published config (ai21labs/Jamba-v0.1 config.json:
# hidden 4096, intermediate 14336, 32 query and 8 key-value heads, 16
# experts top-2, d_state 16, d_conv 4, expand 2, dt_rank 256, vocabulary
# 65536, RMSNorm eps 1e-6, untied head), cut in depth from 32 layers to
# one period of its pattern: 8, attention at layer 4, experts on the odd
# layers, 7 Mamba layers
HF_JAMBA = dict(d_model=4096, n_layers=8, mlp_size=14336,
                num_attention_heads=32, num_key_value_heads=8,
                num_experts=16, num_experts_per_tok=2, d_state=16, d_conv=4,
                expand_factor=2, dt_rank=256, vocab_size=65536,
                rms_norm_eps=1e-6, tie_lm_weights=False)
HF_PROMPT = (2, 64)
HF_NEW_TOKENS = 16
# the port's JambaLM names -> HF's, applied in order (experts unstacked
# apart)
HF_NAMES = ((r"^embedding\.", "model.embed_tokens."),
            (r"^final_layernorm\.", "model.final_layernorm."),
            (r"^jamba\.layers\.", "model.layers."),
            (r"\.pre_moe_layernorm\.", ".pre_ff_layernorm."),
            (r"\.moe\.router\.", ".feed_forward.router."),
            (r"\.moe\.expert\.", ".feed_forward."),
            (r"\.B_layernorm\.", ".b_layernorm."),
            (r"\.C_layernorm\.", ".c_layernorm."))
# (d): DSB2018 stage 1's most common image size
DSB_IMAGES, DSB_SIZE = 8, (256, 256)
# (e), (f)
VOLUMETRIC_SHAPE = (256, 256, 170)
# the canonical generator's skips: (spatial, channels) of encoder 1 and 2
# (the decoder's match them)
SKIP_SHAPES = ((IMG, 64), (tuple(n // 2 for n in IMG), 128))
DISC2D_SHAPE = (4, 256, 256, 1)


def forward_ms_and_peak(model, x, reps: int = 3) -> tuple[float, float]:
    """``model(x)``'s device time (CUDA events, after a warm-up) and the
    peak of allocated memory over the calls, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), reps)
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def check_close(tag: str, got, want, tol: float,
                phase: int = 16) -> tuple[float, float]:
    """max |got - want| and that over max |want| (no floor), which must
    be within ``tol``; both logged with max |want|."""
    err, _ = rel_err(got, want)
    scale = want.detach().abs().max().item()
    rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    log(f"phase {phase}{tag}: card vs CPU max_abs_err={err:.3e} max|CPU|="
        f"{scale:.3e} rel={rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"phase {phase}{tag}: card and CPU differ: "
                             f"rel {rel}")
    return err, rel


def p16_baselines(card: str) -> dict:
    """Phase 16(a) and (b): ResNet3D-101 (Kinetics widths, conv1_t_size 7,
    max pool; a T1 volume in, one logit out) and MVCSNet at its defaults
    (base 64, heads 16/8/4/2, one class), eval, weights from a seed: the
    pooled features the head reads (2048 and 512 wide), card against CPU
    at batch 1 on a reduced volume (the logit, one number, only logged
    beside them), then the forward timed at batch 4 on the canonical
    volume with its FLOPs (counted by ``torch.utils.flop_counter`` on the
    meta device) and peak memory."""
    from torch.utils.flop_counter import FlopCounterMode

    from gfe_mamba_torch.models.mvcs import MVCSNet
    from gfe_mamba_torch.models.resnet3d import generate_model

    out = {}
    for tag, name, make, seed in (
            ("(a)", "ResNet3D-101",
             lambda: generate_model(101, n_input_channels=1, n_classes=1),
             161),
            ("(b)", "MVCSNet", MVCSNet, 162)):
        model = materialized(make, seed).eval()
        x = torch.randn(1, *P16_PARITY_VOLUME, 1,
                        generator=torch.Generator().manual_seed(seed))
        with torch.inference_mode():
            want = model.features(x), model(x)
        model.cuda()
        with torch.inference_mode():
            got = model.features(x.cuda()), model(x.cuda())
        err = check_close(f"{tag} {name} pooled features "
                          f"{tuple(got[0].shape)} at (1, "
                          f"{P16_PARITY_VOLUME})", got[0], want[0], 1e-4)
        log(f"phase 16{tag} {name}: logit card {got[1].item():.6e} CPU "
            f"{want[1].item():.6e}")
        xb = torch.randn(P16_BATCH, *IMG, 1, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
        ms, peak = forward_ms_and_peak(model, xb)
        with torch.device("meta"), torch.no_grad(), \
                FlopCounterMode(display=False) as flops:
            make().eval()(torch.empty(xb.shape))
        tflop = flops.get_total_flops() / 1e12
        with torch.inference_mode():
            logits = model(xb)
        if logits.shape != (P16_BATCH, 1) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"phase 16{tag} {name}: logits "
                                 f"{tuple(logits.shape)} not finite")
        log(f"phase 16{tag} {name}: forward at batch {P16_BATCH} on {IMG} "
            f"f32 {ms:.2f} ms, {tflop:.4f} TFLOP ({tflop / ms * 1e3:.1f} "
            f"TFLOP/s, {tflop * 1e12 / PEAK_F32 / ms * 1e3:.1%} of the f32 "
            f"peak), peak memory {peak:.2f} GiB [{card}]; TFLOP by op "
            + ", ".join(f"{op} {n / 1e12:.4f}" for op, n in
                        flops.get_flop_counts()["Global"].items()))
        out[name] = dict(ms=ms, tflop=tflop, peak_gib=peak,
                         max_abs_err=err[0], rel_err=err[1])
        del model, xb, logits
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def jamba_on_card(cfg, seed: int):
    """A ``JambaLM`` of ``cfg`` built on the card and drawn there from
    ``seed`` at the torch law's scales (``init_weights`` draws on the
    CPU, one thread, minutes at 13e9 parameters): U(-s, s), s = fan_in
    ^ -0.5, for every matrix, conv and bias (the stacked experts over
    their in axis), the embedding N(0, init_std), the norms 1, then the
    Mamba dt, A and D laws (``reset_ssm_parameters``, from a CPU
    generator)."""
    from gfe_mamba_torch.models.jamba import JambaLM
    from gfe_mamba_torch.models.mamba import MambaBlock, RMSNorm
    from gfe_mamba_torch.utils.initializers import kernel_fan_in

    with torch.device("meta"):
        lm = JambaLM(cfg)
    lm.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    drawn = set()
    for mod in lm.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, RMSNorm):
                p.fill_(1.0)
            elif isinstance(mod, torch.nn.Embedding):
                p.normal_(0.0, mod.init_std, generator=gen)
            elif name.startswith("experts_") or name in ("weight", "bias"):
                s = (p.shape[1] if name.startswith("experts_")
                     else kernel_fan_in(mod)) ** -0.5
                p.uniform_(-s, s, generator=gen)
            elif not isinstance(mod, MambaBlock):
                raise AssertionError(f"{name} of {type(mod).__name__} has "
                                     f"no law here")
            drawn.add(id(p))
    cpu_gen = torch.Generator().manual_seed(seed)
    for mod in lm.modules():
        if isinstance(mod, MambaBlock):
            mod.reset_ssm_parameters(cpu_gen)
    if len(drawn) != len(list(lm.parameters())):
        raise AssertionError("phase 16(c): a parameter was not drawn")
    return lm


def hf_state_dict(state: dict) -> dict:
    """A ``JambaLM`` state dict under HF Jamba's names, each stacked
    expert tensor split into one ``(f, d)`` / ``(d, f)`` view per expert
    (no copy)."""
    out = {}
    for key, value in state.items():
        m = re.fullmatch(r"jamba\.layers\.(\d+)\.moe\.experts_(\w+)", key)
        if m:
            for e, w in enumerate(value):
                out[f"model.layers.{m[1]}.feed_forward.experts.{e}."
                    f"{m[2]}_proj.weight"] = w.T
            continue
        for pattern, repl in HF_NAMES:
            key = re.sub(pattern, repl, key)
        out[key] = value
    return out


def p16_hf_jamba(card: str) -> dict:
    """Phase 16(c): Jamba-v0.1's widths at one period of its layers
    (``HF_JAMBA``), drawn on the card from a seed and copied to the host
    (53 GB), handed under HF's names to ``import_jamba_hf`` into a
    ``JambaLM`` built on the card: every tensor back bitwise; the logits
    of a prompt of 64 tokens at batch 2 against a CPU ``JambaLM`` that
    holds the host copy itself (no second copy); ``generate`` of 16
    tokens (top_k 1, the greedy argmax of the forward); K2's launches
    over both (7 per forward, none in the recurrent steps), then K2
    against its plain version on the first Mamba layer's operands of
    this prompt, timed beside its bound."""
    import gc

    from gfe_mamba_torch.models.jamba import JambaConfig, JambaLM, generate
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    from gfe_mamba_torch.utils.torch_import import import_jamba_hf

    cfg = JambaConfig(**HF_JAMBA)
    t = time.perf_counter()
    source = jamba_on_card(cfg, seed=163)
    n_params = sum(p.numel() for p in source.parameters())
    host = {k: v.cpu() for k, v in source.state_dict().items()}
    del source
    torch.cuda.empty_cache()
    draw_s = time.perf_counter() - t
    with torch.device("meta"):
        lm = JambaLM(cfg)
    lm.to_empty(device="cuda")
    t = time.perf_counter()
    import_jamba_hf(hf_state_dict(host), lm).eval()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    for key, value in lm.state_dict().items():
        if not torch.equal(value, host[key].cuda()):
            raise AssertionError(f"phase 16(c): {key} did not come back")
    with torch.device("meta"):
        cpu = JambaLM(cfg)
    cpu.load_state_dict(host, assign=True)
    cpu.eval()
    prompt = torch.randint(0, cfg.vocab_size, HF_PROMPT,
                           generator=torch.Generator().manual_seed(164))
    t = time.perf_counter()
    with torch.inference_mode():
        want = cpu(prompt)[0]
    cpu_s = time.perf_counter() - t
    del cpu, host
    gc.collect()
    k2.launches = 0
    with torch.inference_mode():
        got = lm(prompt.cuda())[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens = generate(lm, prompt.cuda(), HF_NEW_TOKENS,
                      torch.Generator(device="cuda").manual_seed(165),
                      top_k=1)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t) * 1e3
    launches = k2.launches
    err = check_close(f"(c) JambaLM from HF keys, logits {tuple(got.shape)}",
                      got, want, 1e-4)
    scans = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    if launches != scans:
        raise AssertionError(f"phase 16(c): {launches} K2 launches, expected "
                             f"{scans} (one per Mamba layer of the forward)")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        greedy = lm(tokens)[0][:, HF_PROMPT[1] - 1:-1].argmax(-1)
        forward_ms = time_ms(lambda: lm(prompt.cuda()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.equal(greedy, tokens[:, HF_PROMPT[1]:]):
        raise AssertionError("phase 16(c): generate(top_k=1) is not greedy")
    # K2 at this path's shapes: layer 0's operands
    layer = lm.jamba.layers[0]
    with torch.inference_mode():
        args = layer.mamba.scan_operands(
            layer.input_layernorm(lm.embedding(prompt.cuda())))
        y = k2.selective_scan_cuda(*args, delta_softplus=True)
        ref = k2.selective_scan_plain(*args, delta_softplus=True)
        torch.cuda.synchronize()
        k2_err = rel_err(y, ref)
        ms = time_ms(lambda: k2.selective_scan_cuda(*args,
                                                    delta_softplus=True),
                     reps=50)
        plain = time_ms(lambda: k2.selective_scan_plain(
            *args, delta_softplus=True))
    bound, bound_by = scan_bound_ms(args, y)
    shape = tuple(args[0].shape) + (args[2].shape[1],)
    log(f"phase 16(c) K2 on the HF-imported model's layer 0 {shape} f32: "
        f"max_abs_err={k2_err[0]:.3e} rel={k2_err[1]:.3e} (tol 1e-5); "
        f"{ms:.4f} ms per call through the wrapper, plain {plain:.4f} ms, "
        f"bound {bound:.5f} ms ({bound_by})")
    if not k2_err[1] <= 1e-5:
        raise AssertionError("phase 16(c): K2 disagrees with its plain "
                             "version")
    log(f"phase 16(c): {n_params} parameters drawn on the card and copied "
        f"to the host in {draw_s:.2f} s, imported onto the card in "
        f"{load_s:.2f} s (host clock); CPU forward {cpu_s:.2f} s; card "
        f"forward {forward_ms:.2f} ms at {HF_PROMPT}, peak memory "
        f"{peak:.2f} GiB; generate {HF_NEW_TOKENS} tokens {gen_ms:.1f} ms "
        f"(host clock); K2 launches {launches} [{card}]")
    del lm, args, y, ref
    torch.cuda.empty_cache()
    return dict(launches=launches, parameters=n_params,
                logits_max_abs_err=err[0], logits_rel_err=err[1],
                forward_ms=forward_ms, peak_gib=peak, generate_ms=gen_ms,
                load_s=load_s,
                k2=dict(per=f"one call at {shape} f32 (batch, L, ED, N), "
                            f"through the wrapper",
                        max_abs_err=k2_err[0], rel_err=k2_err[1], ms=ms,
                        plain_ms=plain, bound_ms=bound, bound_by=bound_by))


def p16_dsb(card: str, root: str) -> dict:
    """Phase 16(d): 8 RGBA PNGs of 256x256 and their masks through
    ``DSB2018Dataset``, ``UNet2D`` at the JAX package's defaults (f_maps
    64, gcr, 4 levels, sigmoid) on the card, ``dsb_predict``'s files read
    back by ``data/h5.py``: predictions against the CPU's within 1e-4, each
    file's segmentation that of its own predictions."""
    import numpy as np

    from gfe_mamba_torch.data import h5
    from gfe_mamba_torch.data.png import write_png
    from gfe_mamba_torch.segmentation.dsb import DSB2018Dataset
    from gfe_mamba_torch.segmentation.predictor import (dsb_predict,
                                                        pmaps_to_segmentation)

    rng = np.random.default_rng(166)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    yy, xx = np.mgrid[:DSB_SIZE[0], :DSB_SIZE[1]]
    for i in range(DSB_IMAGES):
        blobs = np.zeros(DSB_SIZE, bool)
        for cy, cx, r in zip(*(rng.integers(0, n, 12) for n in DSB_SIZE),
                             rng.integers(6, 20, 12)):
            blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        rgba = rng.integers(0, 60, DSB_SIZE + (4,))
        rgba[blobs, :3] += 150
        rgba[..., 3] = 255
        write_png(os.path.join(root, "images", f"{i:02d}.png"), rgba)
        write_png(os.path.join(root, "masks", f"{i:02d}.png"),
                  blobs.astype(np.uint8) * 255)
    data = DSB2018Dataset(root, "train")
    items = [data[i] for i in range(len(data))]
    batch = np.stack([item["raw"] for item in items])
    if batch.shape != (DSB_IMAGES, *DSB_SIZE, 1) or not all(
            "label" in item for item in items):
        raise AssertionError(f"phase 16(d): dataset gave {batch.shape}")
    model = seg_model(dict(name="UNet2D", in_channels=1, out_channels=1),
                      seed=167)
    with torch.inference_mode():
        want = model(torch.from_numpy(batch)).numpy()
    model.cuda()

    def predict(images):
        with torch.inference_mode():
            return model(torch.from_numpy(images).cuda()).cpu().numpy()

    out_dir = os.path.join(root, "predictions")
    os.makedirs(out_dir)
    t = time.perf_counter()
    files = dsb_predict(predict, [(batch, [os.path.join(
        root, "images", item["name"]) for item in items])], out_dir)
    predict_s = time.perf_counter() - t
    preds = np.stack([h5.read(f, "predictions") for f in files])
    err = check_close("(d) UNet2D over DSB2018 PNGs, dsb_predict's files",
                      torch.from_numpy(preds), torch.from_numpy(want[..., 0]),
                      1e-4)
    flips = 0
    for f, pred, cpu_pred in zip(files, preds, want[..., 0]):
        seg = h5.read(f, "segmentation")
        if seg.dtype != np.uint16 or not np.array_equal(
                seg, pmaps_to_segmentation(pred)):
            raise AssertionError(f"phase 16(d): {f}: segmentation is not "
                                 f"that of its predictions")
        flips += int(((pred > 0.5) != (cpu_pred > 0.5)).sum())
    ms, peak = forward_ms_and_peak(
        model, torch.from_numpy(batch).cuda())
    log(f"phase 16(d): {len(files)} files in {predict_s:.2f} s (host clock, "
        f"forward and writes); UNet2D forward at {batch.shape} {ms:.2f} ms, "
        f"peak {peak:.2f} GiB; {flips} pixels thresholded otherwise than on "
        f"the CPU [{card}]")
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, peak_gib=peak, max_abs_err=err[0], rel_err=err[1])


def p16_volumetric(card: str) -> dict:
    """Phase 16(e): on a 256x256x170 volume made from a seed (an ellipsoid
    of tissue in noise with negatives), ``adaptive_normal``,
    ``foreground_bbox_jax`` and ``crop_resize`` to 160x160x96 (the box
    and the crop under CUDA's sync debug mode set to raise: no host sync)
    and a downsampling ``resize_volume``, each card against CPU, each
    timed."""
    from gfe_mamba_torch.ops import volumetric as vol

    g = torch.Generator().manual_seed(168)
    grid = torch.meshgrid(*(torch.linspace(-1.0, 1.0, n)
                            for n in VOLUMETRIC_SHAPE), indexing="ij")
    head = (grid[0] / 0.7) ** 2 + (grid[1] / 0.8) ** 2 \
        + (grid[2] / 0.6) ** 2 < 1.0
    img = torch.where(head, 400.0 + 400.0 * torch.rand(
        VOLUMETRIC_SHAPE, generator=g), 0.0) \
        + 5.0 * torch.randn(VOLUMETRIC_SHAPE, generator=g)

    def pipeline(x):
        norm = vol.adaptive_normal(x)
        start, stop = vol.foreground_bbox_jax(x, 100.0)
        return (norm, start, stop,
                vol.crop_resize(norm, start, stop, IMG),
                vol.resize_volume(norm, IMG))

    want = pipeline(img)
    x = img.cuda()
    got = pipeline(x)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start, stop = vol.foreground_bbox_jax(x, 100.0)
        vol.crop_resize(got[0], start, stop, IMG)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name, a, b in (("start", got[1], want[1]), ("stop", got[2], want[2])):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"phase 16(e): box {name} {a.tolist()} != "
                                 f"{b.tolist()}")
    errors = {name: check_close(f"(e) {name} {tuple(a.shape)}", a, b, 1e-5)
              for name, a, b in (("adaptive_normal", got[0], want[0]),
                                 ("crop_resize", got[3], want[3]),
                                 ("resize_volume", got[4], want[4]))}
    times = {"adaptive_normal": time_ms(lambda: vol.adaptive_normal(x)),
             "foreground_bbox_jax": time_ms(
                 lambda: vol.foreground_bbox_jax(x, 100.0)),
             "crop_resize": time_ms(lambda: vol.crop_resize(
                 got[0], got[1], got[2], IMG)),
             "resize_volume": time_ms(lambda: vol.resize_volume(got[0], IMG)),
             "pipeline": time_ms(lambda: pipeline(x))}
    log(f"phase 16(e): box {got[1].tolist()}..{got[2].tolist()}; ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" [{card}]")
    return dict(times=times, errors=errors)


def p16_combiners(card: str) -> dict:
    """Phase 16(f): the legacy combiners at the canonical generator's skip
    shapes (batch 1) and ``PatchDiscriminator(dims=2)`` (3 layers, 32
    channels) on 256x256 at batch 4, card against CPU within 1e-4, each
    forward timed on the card."""
    from gfe_mamba_torch.models import combiners as comb
    from gfe_mamba_torch.models.discriminator import PatchDiscriminator

    g = torch.Generator().manual_seed(169)
    enc = [torch.randn(1, *s, c, generator=g) for s, c in SKIP_SHAPES]
    dec = [torch.randn(1, *s, c, generator=g) for s, c in SKIP_SHAPES]
    # the fused head's external token, as wide as the pyramid descriptor
    width = comb.CombineClassifierFused(spatial=IMG).fully_con.in_features
    ft = torch.randn(1, 1, width // 2, generator=g)
    cases = (("CombineClassifier",
              lambda: comb.CombineClassifier(spatial=IMG), ()),
             ("CombineClassifierFused",
              lambda: comb.CombineClassifierFused(spatial=IMG), (ft,)),
             ("CombineClassifier2", comb.CombineClassifier2, ()),
             ("CombineClassifier3", comb.CombineClassifier3, ()),
             ("CombineClassifierCross", comb.CombineClassifierCross, ()),
             ("CombineClassifierEmb", comb.CombineClassifierEmb, ()))
    enc_c, dec_c = [t.cuda() for t in enc], [t.cuda() for t in dec]
    out = {}
    for i, (name, make, extra) in enumerate(cases):
        model = materialized(make, seed=170 + i).eval()
        with torch.inference_mode():
            want = model(enc, dec, *extra)
        model.cuda()
        extra_c = [t.cuda() for t in extra]
        with torch.inference_mode():
            got = model(enc_c, dec_c, *extra_c)
            ms = time_ms(lambda: model(enc_c, dec_c, *extra_c))
        out[name] = dict(ms=ms, err=check_close(
            f"(f) {name} {tuple(got.shape)}", got, want, 1e-4))
        del model
    disc = PatchDiscriminator(3, 32, dims=2)
    disc.reset_parameters(torch.Generator().manual_seed(176))
    x = torch.randn(*DISC2D_SHAPE, generator=g)
    with torch.inference_mode():
        want = disc(x)
        disc.cuda()
        got = disc(x.cuda())
        ms = time_ms(lambda: disc(x.cuda()))
    for i, (a, b) in enumerate(zip(got, want)):
        check_close(f"(f) PatchDiscriminator(dims=2) feature {i} "
                    f"{tuple(a.shape)}", a, b, 1e-4)
    out["PatchDiscriminator2D"] = dict(ms=ms)
    log("phase 16(f): forward ms " + ", ".join(
        f"{k} {v['ms']:.2f}" for k, v in out.items()) + f" [{card}]")
    torch.cuda.empty_cache()
    return out


def drive_other_modules(card: str) -> dict:
    """Phase 16: what the JAX package holds outside the main paths, on the
    card in f32 with TF32 off."""
    t0 = time.perf_counter()
    out = {}
    with tf32_settings(False, False), \
            tempfile.TemporaryDirectory(prefix="gfe_dsb_") as root:
        for part, name, run in (
                ("(a), (b)", "baselines", p16_baselines),
                ("(c)", "hf_jamba", p16_hf_jamba),
                ("(d)", "dsb", lambda c: p16_dsb(c, root)),
                ("(e)", "volumetric", p16_volumetric),
                ("(f)", "combiners", p16_combiners)):
            torch.cuda.reset_peak_memory_stats()
            out[name] = run(card)
            log(f"phase 16{part}: peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s of wall [{card}]")
    return out


# phase 17: the ViT zoo at the widths of upstream vit-pytorch's README
# usage examples (lucidrains/vit-pytorch, which the reference vendors as
# vit_pytorch_diy), f32 with TF32 off; the card-against-CPU checks at a
# smaller batch (and, for volumes, a smaller volume), never at smaller
# widths or depths
P17_BATCH = 32
P17_PARITY_BATCH = 2
P17_SSL_PARITY_BATCH = 4
P17_VOLUME = (96, 160, 160)          # GFE-Mamba's volume, depth axis first
P17_VOLUME_BATCH = 4
P17_PARITY_VOLUME = (48, 64, 64)
P17_AUG_SHAPE = (32, 256, 256, 3)


@contextlib.contextmanager
def no_default_init():
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


def zoo_model(make, seed: int):
    """``make()`` on the CPU, its weights drawn from ``seed``
    (``init_zoo``)."""
    from gfe_mamba_torch.models.vit_zoo import init_zoo

    with no_default_init():
        model = make()
    return init_zoo(model, torch.Generator().manual_seed(seed))


def p17_image_models() -> list:
    """(part, name, make, input shape without the batch, train mode) of
    the 2D and 1D members; widths of each README example, mapped onto the
    JAX fields (the JAX default where a field has none)."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x
    from gfe_mamba_torch.models import vit_zoo_simple as s
    from gfe_mamba_torch.models.vit import Transformer

    vitb = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024,
                depth=6, heads=16, mlp_dim=2048)
    p16 = dict(vitb, patch_size=16)
    i256, i224 = (256, 256, 3), (224, 224, 3)
    cct = dict(embedding_dim=384, n_conv_layers=2, kernel_size=7, stride=2,
               num_layers=14, num_heads=6, mlp_ratio=3.0)
    return [
        ("(a)", "ClassifierViT", lambda: z.ClassifierViT(**vitb), i256),
        ("(a)", "SimpleViT", lambda: z.SimpleViT(**vitb), i256),
        ("(a)", "DeepViT", lambda: x.DeepViT(**vitb), i256),
        ("(a)", "SimpleViTQKNorm", lambda: s.SimpleViTQKNorm(**vitb), i256),
        ("(a)", "SimpleViTRegisterTokens",
         lambda: s.SimpleViTRegisterTokens(**vitb, num_register_tokens=4),
         i256),
        ("(a)", "SimpleViTFFT",
         lambda: s.SimpleViTFFT(**vitb, freq_patch_size=32), i256),
        ("(a)", "SimpleFlashAttnViT", lambda: s.SimpleFlashAttnViT(**vitb),
         i256),
        ("(a)", "SimpleViTPatchDropout",
         lambda: s.SimpleViTPatchDropout(**vitb, patch_dropout=0.5), i256,
         True),
        ("(a)", "ViTPatchDropout",
         lambda: s.ViTPatchDropout(**vitb, patch_dropout=0.25), i256),
        ("(a)", "ParallelViT",
         lambda: s.ParallelViT(**dict(vitb, heads=8),
                               num_parallel_branches=2), i256),
        ("(a)", "ViTForSmallDataset", lambda: s.ViTForSmallDataset(**p16),
         i256),
        ("(a)", "LocalViT", lambda: s.LocalViT(**p16), i256),
        ("(b)", "CaiT", lambda: x.CaiT(**dict(vitb, depth=12), cls_depth=2),
         i256),
        ("(b)", "ViTWithPatchMerger",
         lambda: s.ViTWithPatchMerger(**dict(p16, depth=12, heads=8),
                                      patch_merge_layer=6,
                                      patch_merge_num_tokens=8), i256),
        ("(b)", "EfficientViT",
         lambda: s.EfficientViT(224, 32, 1000, 512,
                                Transformer(512, 12, 8, 64, 2048)), i224),
        ("(c)", "PiT", lambda: x.PiT(224, 14, 1000, 256, (3, 3, 3),
                                     (16, 16, 16), 2048), i224),
        ("(c)", "T2TViT", lambda: x.T2TViT(224, 1000, 512, 5, 8, 512),
         i224),
        ("(c)", "CrossViT",
         lambda: x.CrossViT(256, 1000, sm_patch_size=16, lg_patch_size=64,
                            sm_dim=192, lg_dim=384, sm_enc_depth=2,
                            lg_enc_depth=3, cross_attn_depth=2,
                            multi_scale_enc_depth=4, heads=8, dim_head=64),
         i256),
        ("(c)", "CvT", lambda: x.CvT(1000, depths=(1, 2, 10)), i224),
        ("(c)", "NesT", lambda: x.NesT(224, 4, 1000, 96, 3, 3, (2, 2, 8)),
         i224),
        ("(c)", "MobileViT",
         lambda: x.MobileViT((256, 256), (96, 120, 144),
                             (16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384),
                             1000), i256),
        ("(c)", "CCT", lambda: x.CCT(1000, **cct, image_size=224), i224),
        ("(d)", "SimpleViT1D",
         lambda: s.SimpleViT1D(256, 16, 1000, 1024, 6, 8, 2048), (256, 3)),
        ("(d)", "ViT1D", lambda: s.ViT1D(256, 16, 1000, 1024, 6, 8, 2048),
         (256, 3)),
    ]


def p17_volume_models(volume) -> list:
    """(name, make, whether it reads (B, H, W, D, C) rather than (B, D,
    H, W, C), its importer) of the 3D members over a ``volume`` (D, H, W)
    with one channel."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x
    from gfe_mamba_torch.utils import torch_import as imp

    d, h, w = volume
    return [
        ("ViT3D", lambda: z.ViT3D((h, w), d, 16, 16, 1000, 1024, 6, 8, 2048,
                                  channels=1), True, imp.import_vit3d),
        ("SimpleViT3D", lambda: x.SimpleViT3D(
            (d, h, w), (16, 16, 16), 1000, 1024, 6, 8, 2048, channels=1),
         False, imp.import_simple_vit3d),
        ("ViViT", lambda: x.ViViT((h, w), (16, 16), d, 16, 1000, 1024, 6, 6,
                                  8, 2048, channels=1), False,
         imp.import_vivit),
        ("CCT3D", lambda: x.CCT3D(
            num_classes=1000, embedding_dim=384, n_conv_layers=2,
            kernel_size=7, stride=2, num_layers=14, num_heads=6,
            mlp_ratio=3.0, frame_kernel_size=3, image_size=(h, w), frames=d,
            channels=1), False, imp.import_cct),
    ]


def p17_check(tag: str, name: str, got, want) -> float:
    """Pooled features (each of a tuple) and logits, card against CPU
    within 1e-4 of the CPU's own largest magnitude; the worst ratio."""
    feats_g, feats_w = got[0], want[0]
    if not isinstance(feats_g, tuple):
        feats_g, feats_w = (feats_g,), (feats_w,)
    worst = 0.0
    for i, (a, b) in enumerate(zip(feats_g, feats_w)):
        worst = max(worst, check_close(
            f"{tag} {name} pooled features {i} {tuple(a.shape)}", a, b,
            1e-4, phase=17)[1])
    return max(worst, check_close(f"{tag} {name} logits "
                                  f"{tuple(got[1].shape)}", got[1], want[1],
                                  1e-4, phase=17)[1])


def p17_timed(card: str, tag: str, name: str, model, xb) -> dict:
    """The forward at the timed batch: ms, FLOPs (``torch.utils.
    flop_counter``), peak memory; the logits finite."""
    from torch.utils.flop_counter import FlopCounterMode

    ms, peak = forward_ms_and_peak(model, xb)
    # the counter's module hooks fail on a view of a parameter that
    # requires grad made outside grad mode: the parameters stop requiring
    # it while they count
    model.requires_grad_(False)
    with torch.inference_mode(), FlopCounterMode(display=False) as flops:
        logits = model(xb)
    model.requires_grad_(True)
    if logits.shape != (xb.shape[0], 1000) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"phase 17{tag} {name}: logits "
                             f"{tuple(logits.shape)} not finite")
    tflop = flops.get_total_flops() / 1e12
    log(f"phase 17{tag} {name}: forward at {tuple(xb.shape)} f32 "
        f"{ms:.3f} ms, {tflop:.4f} TFLOP ({tflop / ms * 1e3:.1f} TFLOP/s, "
        f"{tflop * 1e12 / PEAK_F32 / ms * 1e3:.1%} of the f32 peak), peak "
        f"memory {peak:.2f} GiB [{card}]")
    return dict(ms=ms, tflops=tflop / ms * 1e3, peak_gib=peak)


def p17_classifier(card: str, tag: str, name: str, make, shape,
                   seed: int, train: bool = False) -> dict:
    """(i) weights from ``seed`` on the CPU, copied to the card; (ii) pooled
    features and logits card against CPU at ``P17_PARITY_BATCH``; (iii),
    (iv) the forward timed at ``P17_BATCH``.  ``train``: patch dropout
    active, the parity's scores drawn once on the CPU and shared, the
    timed run drawing from a CUDA generator."""
    from gfe_mamba_torch.models.dropout import seed_dropout

    model = zoo_model(make, seed)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(P17_PARITY_BATCH, *shape, generator=g)
    if train:
        drop = model.train().patch_dropout
        scores = torch.randn(P17_PARITY_BATCH, model.pos.shape[0],
                             generator=g)
        drop.scores = lambda rows, n, device: scores.to(device)
        seed_dropout(model, g)
    else:
        model.eval()
    with torch.inference_mode():
        want = model.features(x), model(x)
    model.cuda()
    xc = x.cuda()
    with torch.inference_mode():
        got = model.features(xc), model(xc)
    err = p17_check(tag, name, got, want)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    if train:
        del drop.scores
        seed_dropout(model, cuda_gen)
    xb = torch.rand(P17_BATCH, *shape, device="cuda", generator=cuda_gen)
    out = dict(p17_timed(card, tag, name, model, xb), rel=err)
    del model
    torch.cuda.empty_cache()
    return out


def p17_volumes(card: str, seed: int = 185) -> dict:
    """(e) and the importers: each 3D member at ``P17_PARITY_VOLUME``
    (batch 1) drawn on the CPU, its state_dict (the reference's names)
    loaded onto a model on the card by its importer, features and logits
    card against CPU; then a model at ``P17_VOLUME`` timed at batch
    ``P17_VOLUME_BATCH``."""
    out = {}
    small = p17_volume_models(P17_PARITY_VOLUME)
    full = p17_volume_models(P17_VOLUME)
    for i, ((name, make, hwd, importer), (_, make_full, _, _)) in \
            enumerate(zip(small, full)):
        model = zoo_model(make, seed + i).eval()
        g = torch.Generator().manual_seed(seed + i)
        x = torch.rand(1, *P17_PARITY_VOLUME, 1, generator=g)
        if hwd:
            x = x.permute(0, 2, 3, 1, 4)
        with torch.inference_mode():
            want = model.features(x), model(x)
        with no_default_init():
            card_model = make().cuda().eval()
        t = time.perf_counter()
        importer(model.state_dict(), card_model)
        import_s = time.perf_counter() - t
        with torch.inference_mode():
            got = card_model.features(x.cuda()), card_model(x.cuda())
        err = p17_check("(e)", f"{name} imported", got, want)
        del model, card_model
        cuda_gen = torch.Generator(device="cuda").manual_seed(seed + i)
        xb = torch.rand(P17_VOLUME_BATCH, *P17_VOLUME, 1, device="cuda",
                        generator=cuda_gen)
        if hwd:
            xb = xb.permute(0, 2, 3, 1, 4)
        model = zoo_model(make_full, seed + i).cuda().eval()
        out[name] = dict(p17_timed(card, "(e)", name, model, xb), rel=err,
                         import_s=import_s)
        log(f"phase 17(e) {name}: import onto the card {import_s:.2f} s")
        del model
        torch.cuda.empty_cache()
    return out


def p17_loss_and_grads(card: str, name: str, model, step, x, xb,
                       share, unshare, batch: int = P17_BATCH,
                       phase: str = "17(f)") -> dict:
    """A loss and its backward on the CPU and on the card from the same
    weights, inputs and draws (``share``): the loss and every gradient
    within 1e-4 of the CPU's own largest magnitude; then (``unshare``:
    draws from a CUDA generator) the forward and backward timed at the
    batch of ``xb``.  ``phase`` labels the log lines."""
    from torch.utils.flop_counter import FlopCounterMode

    share()
    loss = step(model, x)
    loss.backward()
    # a parameter the loss does not reach (MP3's ViT head) has no
    # gradient on either side
    want = {k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.cuda()
    got_loss = step(model, x.cuda())
    got_loss.backward()
    check_close(f"{phase[2:]} {name} loss", got_loss, loss, 1e-4,
                phase=int(phase[:2]))
    worst, where = 0.0, ""
    for key, p in model.named_parameters():
        if (key in want) != (p.grad is not None):
            raise AssertionError(f"phase {phase} {name}: {key} has a "
                                 f"gradient on one side only")
        if key not in want:
            continue
        err, _ = rel_err(p.grad, want[key])
        scale = want[key].abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if not rel <= 1e-4:
            raise AssertionError(f"phase {phase} {name}: gradient of {key} "
                                 f"rel {rel} from the CPU's")
        if rel >= worst:
            worst, where = rel, key
    log(f"phase {phase} {name}: {len(want)} gradients card vs CPU, worst "
        f"rel {worst:.3e} ({where}; tol 1e-4)")
    unshare()
    model.zero_grad(set_to_none=True)

    def train_step():
        step(model, xb).backward()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(train_step, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with FlopCounterMode(display=False) as flops:
        train_step()
    tflop = flops.get_total_flops() / 1e12
    log(f"phase {phase} {name}: loss + backward at batch {batch} f32 "
        f"{ms:.3f} ms, {tflop:.4f} TFLOP ({tflop / ms * 1e3:.1f} TFLOP/s), "
        f"peak memory {peak:.2f} GiB [{card}]")
    return dict(ms=ms, tflops=tflop / ms * 1e3, peak_gib=peak,
                grad_rel=worst)


def p17_ssl(card: str, seed: int = 190) -> dict:
    """(f) MAE and MPP (the ViT-1024 trunk of (a); MAE's decoder 512 wide,
    6 deep) and DINO's head (hidden 256, out 65536) with ``dino_loss``
    and ``ema_update``: loss and backward card against CPU at batch
    ``P17_SSL_PARITY_BATCH`` with the masking draws shared, then timed at
    ``P17_BATCH``."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_extra as x

    out = {}
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(P17_SSL_PARITY_BATCH, 256, 256, 3, generator=g)
    imgb = torch.rand(P17_BATCH, 256, 256, 3, device="cuda",
                      generator=cuda_gen)

    mae = zoo_model(lambda: z.MAE(256, 32, 1024, 6, 16, 2048,
                                  masking_ratio=0.75, decoder_dim=512,
                                  decoder_depth=6, decoder_heads=8), seed)
    perm = z.MAE.permutation(P17_SSL_PARITY_BATCH, 64, g, "cpu")

    def mae_share():
        mae.permutation = lambda b, n, gen, device: perm.to(device)

    def mae_unshare():
        del mae.permutation

    out["MAE"] = p17_loss_and_grads(
        card, "MAE", mae, lambda m, v: m(v, cuda_gen if v.is_cuda else g),
        img, imgb, mae_share, mae_unshare)
    del mae

    mpp = zoo_model(lambda: x.MPP(256, 32, 1024, 6, 8, 2048, channels=3,
                                  mask_prob=0.15, replace_prob=0.5,
                                  random_patch_prob=0.3), seed + 1)
    draws = x.MPP.draws(P17_SSL_PARITY_BATCH, 64, g, "cpu")

    def mpp_share():
        mpp.draws = lambda b, n, gen, device: tuple(d.to(device)
                                                    for d in draws)

    def mpp_unshare():
        del mpp.draws

    out["MPP"] = p17_loss_and_grads(
        card, "MPP", mpp, lambda m, v: m(v, cuda_gen if v.is_cuda else g),
        img, imgb, mpp_share, mpp_unshare)
    del mpp

    student = zoo_model(lambda: z.DinoHead(256, 65536, dim=1024), seed + 2)
    teacher = zoo_model(lambda: z.DinoHead(256, 65536, dim=1024), seed + 3)
    feats = torch.randn(2, P17_SSL_PARITY_BATCH, 1024, generator=g)
    featsb = torch.randn(2, P17_BATCH, 1024, device="cuda",
                         generator=cuda_gen)

    def dino_step(m, v):
        with torch.no_grad():
            t = teacher.to(v.device)(v[1])
        return z.dino_loss(m(v[0]), t)

    out["DINO"] = p17_loss_and_grads(card, "DinoHead + dino_loss", student,
                                     dino_step, feats, featsb, lambda: None,
                                     lambda: None)
    cpu_teacher = copy.deepcopy(teacher).cpu()
    cpu_student = copy.deepcopy(student).cpu()
    z.ema_update(cpu_teacher, cpu_student)
    z.ema_update(teacher, student)
    for (key, a), b in zip(teacher.named_parameters(),
                           cpu_teacher.parameters()):
        check_close(f"(f) ema_update {key}", a, b, 1e-6, phase=17)
    out["ema_update_ms"] = time_ms(lambda: z.ema_update(teacher, student))
    count = sum(p.numel() for p in student.parameters())
    log(f"phase 17(f) ema_update over {count} parameters "
        f"{out['ema_update_ms']:.3f} ms [{card}]")
    del student, teacher
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def draw_tape(aug, tape: list, replay: bool):
    """``augment2d``'s two draw functions recording into ``tape``, or
    handing its tensors back in order (each checked against the shape
    asked for)."""
    saved = aug._uniform, aug._permutation
    if replay:
        it = iter(tape)

        def take(shape):
            value = next(it)
            if value.shape != torch.Size(shape):
                raise AssertionError(f"phase 17(g): replayed draw "
                                     f"{tuple(value.shape)} != {shape}")
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


def p17_augment(card: str, seed: int = 195) -> dict:
    """(g) ``data/augment2d.py`` on 32 images of 256x256x3: each op and
    ``ssl_views_batch`` (views of 224 and of 96), card against CPU within
    1e-5 with the CPU's draws replayed on the card, the card's run under
    CUDA's sync debug mode set to raise (no host sync); each timed on the
    card drawing from a CUDA generator."""
    from gfe_mamba_torch.data import augment2d as aug

    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = torch.rand(*P17_AUG_SHAPE, generator=g)
    b = imgs.shape[0]
    factors = torch.linspace(0.2, 1.8, b)
    shifts = torch.linspace(-0.5, 0.5, b)
    sigmas = torch.linspace(1.0, 2.0, b)
    boxes = aug.sample_crop_box(g, (256, 256), (0.08, 1.0), batch=b)
    fixed = {
        "rgb_to_hsv": lambda x, a: aug.rgb_to_hsv(x),
        "hsv_to_rgb": lambda x, a: aug.hsv_to_rgb(x),
        "grayscale": lambda x, a: aug.grayscale(x),
        "adjust_brightness": lambda x, a: aug.adjust_brightness(x, a[0]),
        "adjust_contrast": lambda x, a: aug.adjust_contrast(x, a[0]),
        "adjust_saturation": lambda x, a: aug.adjust_saturation(x, a[0]),
        "adjust_hue": lambda x, a: aug.adjust_hue(x, a[1]),
        "gaussian_blur": lambda x, a: aug.gaussian_blur(x, a[2]),
        "normalize": lambda x, a: aug.normalize(x),
        "crop_and_resize": lambda x, a: aug.crop_and_resize(x, a[3],
                                                            (224, 224)),
    }
    drawn = {
        "color_jitter": aug.color_jitter,
        "random_grayscale": aug.random_grayscale,
        "random_hflip": aug.random_hflip,
        "random_gaussian_blur": lambda x, gen: aug.random_gaussian_blur(
            x, gen, 0.5),
        "random_resized_crop": lambda x, gen: aug.random_resized_crop(
            x, gen, 224, (0.08, 1.0)),
        "byol_augment": aug.byol_augment,
        "ssl_views_batch 224": lambda x, gen: aug.ssl_views_batch(x, gen,
                                                                  224),
        "ssl_views_batch 96": lambda x, gen: aug.ssl_views_batch(x, gen, 96),
    }
    args = (factors, shifts, sigmas, boxes)
    args_c = tuple(a.cuda() for a in args)
    xc = imgs.cuda()
    out = {}
    for name, op in [*fixed.items(), *drawn.items()]:
        tape = []
        with draw_tape(aug, tape, replay=False):
            want = op(imgs, args) if name in fixed else op(imgs, g)
        tape = [t.cuda() for t in tape]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with draw_tape(aug, tape, replay=True):
                got = op(xc, args_c) if name in fixed else op(xc, None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        rel = max(check_close(f"(g) {name} {i} {tuple(a.shape)}", a, w,
                              1e-5, phase=17)[1]
                  for i, (a, w) in enumerate(zip(got, want)))
        ms = time_ms(lambda: op(xc, args_c) if name in fixed
                     else op(xc, cuda_gen))
        out[name] = dict(ms=ms, rel=rel)
    torch.cuda.set_sync_debug_mode("error")
    try:
        aug.ssl_views_batch(xc, cuda_gen, 224)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"phase 17(g): ms per batch of {b} " + ", ".join(
        f"{k} {v['ms']:.3f}" for k, v in out.items()) + f" [{card}]")
    return out


def drive_zoo(card: str) -> dict:
    """Phase 17: the ViT zoo (``models/vit_zoo*.py``), its importers and
    ``data/augment2d.py`` on the card, f32 with TF32 off."""
    t0 = time.perf_counter()
    out = {}
    with tf32_settings(False, False):
        for i, (tag, name, make, shape, *train) in \
                enumerate(p17_image_models()):
            out[name] = p17_classifier(card, tag, name, make, shape, 180 + i,
                                       *train)
        out.update(p17_volumes(card))
        out.update(p17_ssl(card))
        out["augment2d"] = p17_augment(card)
    models = {k: v for k, v in out.items() if isinstance(v, dict)
              and "tflops" in v}
    log("phase 17 summary: " + json.dumps(
        {k: {m: float(f"{n:.4g}") for m, n in v.items()}
         for k, v in models.items()}))
    worst = max(v.get("rel", v.get("grad_rel", 0.0))
                for v in models.values())
    log(f"phase 17: {len(models)} models, worst card-vs-CPU rel "
        f"{worst:.3e}; {time.perf_counter() - t0:.1f} s of wall [{card}]")
    return out


# phase 18: the ViT zoo's second half (``models/vit_zoo_hier.py``,
# ``models/vit_zoo_final.py``) at the widths of upstream vit-pytorch's
# README usage examples, f32 with TF32 off, eval mode, no kernel; the
# card-against-CPU checks at batch 2, the timing at batch 32, never at
# smaller widths or depths
P18_BATCH = 32
P18_PARITY_BATCH = 2
P18_NAVIT_SIDES = (64, 128, 256)
P18_NAVIT_IMAGES = 32
P18_NAVIT_SEQ = 256


def p18_image_models() -> list:
    """(part, name, make, input shape without the batch) of the image
    classifiers; widths of each README example, mapped onto the JAX fields
    (the JAX default where a field has none, or where the README gives a
    sequence for one value: XCiT's layer_dropout, ScalableViT's per-stage
    ssa_dim_key, RvT's emb_dropout)."""
    from gfe_mamba_torch.models import vit_zoo_final as f
    from gfe_mamba_torch.models import vit_zoo_hier as h

    i224, i256 = (224, 224, 3), (256, 256, 3)
    maxvit = dict(num_classes=1000, dim_conv_stem=64, dim=96, dim_head=32,
                  depth=(2, 2, 5, 2), window_size=7,
                  mbconv_expansion_rate=4, mbconv_shrinkage_rate=0.25)
    vit1024 = dict(image_size=256, num_classes=1000, dim=1024, depth=6,
                   heads=16, mlp_dim=2048)
    return [
        ("(a)", "LeViT", lambda: h.LeViT(224, 1000, (256, 384, 512), 4,
                                         (4, 6, 8), mlp_mult=2), i224),
        ("(a)", "MaxViT", lambda: h.MaxViT(**maxvit), i224),
        ("(a)", "TwinsSVT", lambda: h.TwinsSVT(1000), i224),
        ("(a)", "XCiT",
         lambda: h.XCiT(256, 32, 1000, 1024, 12, 2, 16, 2048), i256),
        ("(a)", "CrossFormer", lambda: h.CrossFormer(1000), i224),
        ("(a)", "RegionViT", lambda: h.RegionViT(1000), i224),
        ("(a)", "ScalableViT",
         lambda: h.ScalableViT(1000, 64, (2, 2, 20, 2), (2, 4, 8, 16),
                               (8, 4, 2, 1), (64, 32, None, None)), i256),
        ("(a)", "SepViT",
         lambda: h.SepViT(1000, 32, (1, 2, 6, 2), (1, 2, 4, 8), 7, 32,
                          image_size=224), i224),
        ("(b)", "MaxViTWithRegisters",
         lambda: f.MaxViTWithRegisters(**maxvit, num_register_tokens=4),
         i224),
        ("(b)", "RvT", lambda: f.RvT(patch_size=32, **vit1024), i256),
        ("(b)", "MemoryAdapter",
         lambda: f.MemoryAdapter(f.MemoryViT(
             256, 16, 1000, 1024, 6, 8, 2048), 5, 2), i256),
    ]


def p18_outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def p18_forward(card: str, tag: str, name: str, model, call, inputs,
                timed_inputs) -> dict:
    """``call(model, *inputs)`` card against CPU (each output within 1e-4
    of the CPU's largest magnitude, integer and boolean ones equal), then
    :func:`p18_time` at ``timed_inputs``."""
    with torch.inference_mode():
        want = p18_outputs(call(model, *inputs))
    model.cuda()
    with torch.inference_mode():
        got = p18_outputs(call(model, *(t.cuda() for t in inputs)))
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.bool or not a.is_floating_point():
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"phase 18{tag} {name}: output {i} "
                                     f"differs from the CPU's")
            continue
        worst = max(worst, check_close(
            f"{tag} {name} output {i} {tuple(a.shape)}", a, b, 1e-4,
            phase=18)[1])
    return dict(p18_time(card, tag, name, model, call, timed_inputs),
                rel=worst)


def p18_time(card: str, tag: str, name: str, model, call,
             timed_inputs) -> dict:
    """``call(model, *timed_inputs)`` on the card timed by CUDA events,
    its FLOPs (``torch.utils.flop_counter``) and peak memory; the outputs
    finite."""
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: call(model, *timed_inputs), reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.requires_grad_(False)
    with torch.inference_mode(), FlopCounterMode(display=False) as flops:
        out = p18_outputs(call(model, *timed_inputs))
    model.requires_grad_(True)
    if not all(torch.isfinite(t).all() for t in out
               if t.is_floating_point()):
        raise AssertionError(f"phase 18{tag} {name}: outputs not finite")
    tflop = flops.get_total_flops() / 1e12
    shape = tuple(timed_inputs[0].shape)
    log(f"phase 18{tag} {name}: forward at {shape} f32 {ms:.3f} ms, "
        f"{tflop:.4f} TFLOP ({tflop / ms * 1e3:.1f} TFLOP/s, "
        f"{tflop * 1e12 / PEAK_F32 / ms * 1e3:.1%} of the f32 peak), peak "
        f"memory {peak:.2f} GiB [{card}]")
    return dict(ms=ms, tflops=tflop / ms * 1e3, peak_gib=peak)


def p18_classifier(card: str, tag: str, name: str, make, shape,
                   seed: int) -> dict:
    """Weights from ``seed`` on the CPU (``init_zoo``), eval mode; the
    logits (and pooled features where the model has them) card against
    CPU at ``P18_PARITY_BATCH``, the forward timed at ``P18_BATCH``."""
    model = zoo_model(make, seed).eval()
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(P18_PARITY_BATCH, *shape, generator=g)
    xb = torch.rand(P18_BATCH, *shape, device="cuda", generator=cuda_gen)
    if hasattr(model, "features"):
        call = (lambda m, v: (m.features(v), m(v)) if v.shape[0] ==
                P18_PARITY_BATCH else m(v))
    else:
        call = (lambda m, v: m(v))
    out = p18_forward(card, tag, name, model, call, (x,), (xb,))
    del model
    torch.cuda.empty_cache()
    return out


def p18_ats(card: str, seed: int = 230) -> dict:
    """(c) ATSViT (256/16, dim 1024, depth 6, tokens 256 .. 8, 16 heads):
    the CPU's Gumbel uniforms handed to the card, the sampled ids exactly
    the CPU's (else the smallest gap between a draw's two best perturbed
    scores is reported), then the logits; timed with draws from a CUDA
    generator."""
    from gfe_mamba_torch.models import vit_zoo_final as f

    model = zoo_model(lambda: f.ATSViT(256, 16, 1000, 1024, 6,
                                       (256, 128, 64, 32, 16, 8), 16, 2048),
                      seed).eval()
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(P18_PARITY_BATCH, 256, 256, 3, generator=g)
    xb = torch.rand(P18_BATCH, 256, 256, 3, device="cuda",
                    generator=cuda_gen)
    layers = [m for m in model.modules() if isinstance(m, f._ATSAttention)]
    tape = {}

    def taped(i):
        def uniforms(shape, gen, device):
            if i not in tape:
                tape[i] = torch.rand(shape, generator=g)
            return tape[i].to(device)
        return uniforms

    margins = {"CPU": math.inf, "card": math.inf}
    side = ["CPU"]
    perturbed = f._ats_perturbed

    def recording(attn, *args):
        s = perturbed(attn, *args)
        top = s.topk(2, dim=-1).values
        margins[side[0]] = min(margins[side[0]],
                               (top[..., 0] - top[..., 1]).min().item())
        return s

    for i, m in enumerate(layers):
        m.uniforms = taped(i)
    f._ats_perturbed = recording
    try:
        with torch.inference_mode():
            want, want_ids = model(x, None, return_sampled_token_ids=True)
        model.cuda()
        side[0] = "card"
        with torch.inference_mode():
            got, ids = model(x.cuda(), None, return_sampled_token_ids=True)
    finally:
        f._ats_perturbed = perturbed
    log(f"phase 18(c) ATSViT: {len(tape)} sampling layers, smallest gap "
        f"between a draw's two best perturbed scores CPU "
        f"{margins['CPU']:.3e} card {margins['card']:.3e}")
    if not torch.equal(ids.cpu(), want_ids):
        raise AssertionError(
            f"phase 18(c) ATSViT: {(ids.cpu() != want_ids).sum().item()} "
            f"sampled ids differ from the CPU's (smallest gap "
            f"{margins['CPU']:.3e})")
    log(f"phase 18(c) ATSViT: the {want_ids.numel()} sampled ids equal the "
        f"CPU's")
    rel = check_close("(c) ATSViT logits with the shared draws", got, want,
                      1e-4, phase=18)[1]
    for m in layers:
        del m.uniforms
    out = dict(p18_time(card, "(c)", "ATSViT", model,
                        lambda m, v: m(v, cuda_gen), (xb,)), rel=rel)
    del model
    torch.cuda.empty_cache()
    return out


def p18_navit(card: str, seed: int = 231) -> dict:
    """(d) NaViT (256/32, dim 1024, depth 6, 16 heads, token dropout 0.1):
    the README's five images (256x256, 128x128 | 128x256, 256x128 |
    64x256) packed by the port's packer, card against CPU; then 32 images
    of sides drawn from {64, 128, 256}, grouped and packed at
    ``max_seq_len`` 256, timed.  Packing is host time, outside the timed
    forward (logged)."""
    import numpy as np

    from gfe_mamba_torch.models import vit_zoo_final as f

    rng = np.random.default_rng(seed)
    readme = [[(256, 256), (128, 128)], [(128, 256), (256, 128)],
              [(64, 256)]]
    groups = [[rng.random((h, w, 3), dtype=np.float32) for h, w in group]
              for group in readme]
    sides = rng.choice(P18_NAVIT_SIDES, size=(P18_NAVIT_IMAGES, 2))
    images = [rng.random((h, w, 3), dtype=np.float32) for h, w in sides]
    t = time.perf_counter()
    timed_groups = f.group_images_by_max_seq_len(
        images, 32, lambda h, w: 0.1, P18_NAVIT_SEQ)
    timed = f.pack_images(timed_groups, 32, P18_NAVIT_SEQ, 0.1, seed=seed)
    pack_s = time.perf_counter() - t
    packed = f.pack_images(groups, 32, P18_NAVIT_SEQ, 0.1, seed=seed)
    most = max(len(g) for g in timed_groups + groups)
    model = zoo_model(lambda: f.NaViT(256, 32, 1000, 1024, 6, 16, 2048,
                                      max_images=most), seed).eval()
    names = ("patches", "positions", "image_ids", "mask")
    inputs = tuple(torch.from_numpy(packed[k]) for k in names)
    timed_inputs = tuple(torch.from_numpy(timed[k]).cuda() for k in names)
    log(f"phase 18(d) NaViT: {P18_NAVIT_IMAGES} images in "
        f"{len(timed_groups)} groups of at most {most} "
        f"({int(timed['mask'].sum())} of "
        f"{timed['mask'].size} token slots filled), packed on the host in "
        f"{pack_s * 1e3:.1f} ms")
    out = p18_forward(card, "(d)", "NaViT", model, lambda m, *a: m(*a),
                      inputs, timed_inputs)
    del model
    torch.cuda.empty_cache()
    return out


def p18_losses(card: str, seed: int = 232) -> dict:
    """(e) the pretraining and adapter losses, loss + backward card
    against CPU at ``P18_PARITY_BATCH`` with the draws shared, then timed
    at ``P18_BATCH``: SimMIM (256/32, 1024, depth 6, 8 heads, masking
    0.5), MP3 (256/8, masking 0.75), DistillWrapper (student 256/32, T 3,
    alpha 0.5; seeded teacher logits) and EsViTProjector (4 layers,
    hidden 256, out 65336) under both EsViT losses over 49 region tokens
    of width 384."""
    from gfe_mamba_torch.models import vit_zoo_final as f

    out = {}
    b, bb = P18_PARITY_BATCH, P18_BATCH
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(b, 256, 256, 3, generator=g)
    imgb = torch.rand(bb, 256, 256, 3, device="cuda", generator=cuda_gen)
    enc = dict(image_size=256, dim=1024, depth=6, heads=8, mlp_dim=2048)

    simmim = zoo_model(lambda: f.SimMIM(patch_size=32, masking_ratio=0.5,
                                        **enc), seed)
    masked = f.SimMIM.masked_indices(b, simmim.pos_embedding.shape[1] - 1,
                                     simmim.num_masked, g, "cpu")

    def simmim_share():
        simmim.masked_indices = lambda *a: masked.to(a[-1])

    def simmim_unshare():
        del simmim.masked_indices

    out["SimMIM"] = p17_loss_and_grads(
        card, "SimMIM", simmim,
        lambda m, v: m(v, cuda_gen if v.is_cuda else g), img, imgb,
        simmim_share, simmim_unshare, P18_BATCH, "18(e)")
    del simmim

    mp3 = zoo_model(lambda: f.MP3(f.MP3ViT(patch_size=8, num_classes=1000,
                                           **enc), 0.75), seed + 1)
    order = f.MP3.permutation(b, mp3.mlp_head_dense.out_features, g, "cpu")

    def mp3_share():
        mp3.permutation = lambda *a: order.to(a[-1])

    def mp3_unshare():
        del mp3.permutation

    out["MP3"] = p17_loss_and_grads(
        card, "MP3", mp3, lambda m, v: m(v, cuda_gen if v.is_cuda else g),
        img, imgb, mp3_share, mp3_unshare, P18_BATCH, "18(e)")
    del mp3

    wrapper = zoo_model(lambda: f.DistillWrapper(f.DistillableViT(
        patch_size=32, num_classes=1000, **enc), temperature=3.0,
        alpha=0.5), seed + 2)
    teacher = torch.randn(bb, 1000, generator=g)
    labels = torch.randint(0, 1000, (bb,), generator=g)

    def distill_step(m, v):
        n = v.shape[0]
        return m(v, labels[:n].to(v.device), teacher[:n].to(v.device))

    out["DistillWrapper"] = p17_loss_and_grads(
        card, "DistillWrapper", wrapper, distill_step, img, imgb,
        lambda: None, lambda: None, P18_BATCH, "18(e)")
    del wrapper

    student = zoo_model(lambda: f.EsViTProjector(65336, 4, 256, dim=384),
                        seed + 3)
    teacher_head = zoo_model(lambda: f.EsViTProjector(65336, 4, 256,
                                                      dim=384), seed + 4)
    feats = torch.randn(2, b, 49, 384, generator=g)
    featsb = torch.randn(2, bb, 49, 384, device="cuda", generator=cuda_gen)
    centers = torch.randn(2, 1, 65336, generator=g) * 0.1

    def esvit_step(m, v):
        c = centers.to(v.device)
        with torch.no_grad():
            head = teacher_head.to(v.device)
            t_view, t_regions = head(v[0].mean(dim=1)), head(v[0])
        view = f.esvit_view_loss(t_view, m(v[1].mean(dim=1)), c[0])
        region = f.esvit_region_loss(t_regions, m(v[1]), v[0], v[1], c[1])
        return view + region

    out["EsViT"] = p17_loss_and_grads(
        card, "EsViTProjector + esvit losses", student, esvit_step, feats,
        featsb, lambda: None, lambda: None, P18_BATCH, "18(e)")
    check_close("(e) esvit_center_update",
                f.esvit_center_update(centers[0].cuda(), centers[1].cuda()),
                f.esvit_center_update(centers[0], centers[1]), 1e-6,
                phase=18)
    del student, teacher_head
    torch.cuda.empty_cache()
    return out


def p18_record(card: str, seed: int = 233) -> dict:
    """(f) ``extract`` and ``record_attention`` on phase 17's ClassifierViT
    (256/32, dim 1024, depth 6, 16 heads): the latent, the maps and the
    logits card against CPU at ``P18_PARITY_BATCH``, every map's rows
    summing to 1, the logits with the recorder bitwise those without it;
    the recorded forward timed beside the plain one at ``P18_BATCH``."""
    from gfe_mamba_torch.models import vit_zoo as z
    from gfe_mamba_torch.models import vit_zoo_final as f

    model = zoo_model(lambda: z.ClassifierViT(256, 32, 1000, 1024, 6, 16,
                                              2048), seed).eval()
    g = torch.Generator().manual_seed(seed)
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(P18_PARITY_BATCH, 256, 256, 3, generator=g)
    xb = torch.rand(P18_BATCH, 256, 256, 3, device="cuda",
                    generator=cuda_gen)
    with torch.inference_mode():
        want, want_latent = f.extract(model, x)
        _, want_maps = f.record_attention(model, x)
    model.cuda()
    with torch.inference_mode():
        got, latent = f.extract(model, x.cuda())
        recorded, maps = f.record_attention(model, x.cuda())
        plain = model(x.cuda())
    if maps.shape != (P18_PARITY_BATCH, 6, 16, 65, 65):
        raise AssertionError(f"phase 18(f): maps {tuple(maps.shape)}")
    worst = max(check_close(f"(f) extract {name}", a, b, 1e-4,
                            phase=18)[1]
                for name, a, b in (("logits", got, want),
                                   ("latent", latent, want_latent),
                                   ("attention maps", maps, want_maps)))
    rows = (maps.sum(dim=-1) - 1).abs().max().item()
    if not rows <= 1e-5:
        raise AssertionError(f"phase 18(f): map rows sum to 1 within {rows}")
    if not (torch.equal(recorded, plain) and torch.equal(got, plain)):
        raise AssertionError("phase 18(f): logits with the hooks differ "
                             "from those without them")
    with torch.inference_mode():
        plain_ms = time_ms(lambda: model(xb), reps=3)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: f.record_attention(model, xb), reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 18(f) record_attention: rows sum to 1 within {rows:.1e}, "
        f"logits bitwise those without hooks; at batch {P18_BATCH} "
        f"{ms:.3f} ms recorded vs {plain_ms:.3f} ms plain, peak memory "
        f"{peak:.2f} GiB [{card}]")
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, peak_gib=peak, rel=worst)


def drive_zoo_final(card: str) -> dict:
    """Phase 18: ``models/vit_zoo_hier.py`` and ``models/vit_zoo_final.py``
    on the card, f32 with TF32 off, eval mode."""
    t0 = time.perf_counter()
    out = {}
    with tf32_settings(False, False):
        for i, (tag, name, make, shape) in enumerate(p18_image_models()):
            out[name] = p18_classifier(card, tag, name, make, shape,
                                       210 + i)
        out["ATSViT"] = p18_ats(card)
        out["NaViT"] = p18_navit(card)
        out.update(p18_losses(card))
        out["record_attention"] = p18_record(card)
    log("phase 18 summary: " + json.dumps(
        {k: {m: float(f"{n:.4g}") for m, n in v.items()}
         for k, v in out.items()}))
    worst = max(v.get("rel", v.get("grad_rel", 0.0)) for v in out.values())
    log(f"phase 18: {len(out)} entries, worst card-vs-CPU rel "
        f"{worst:.3e}; {time.perf_counter() - t0:.1f} s of wall [{card}]")
    return out


# phase 19: the small quality path's f32 conv levels (batch 8), and
# generation_evaluation's batches and its CPU reference
P19_SMALL_LEVELS = (((32, 32, 16), 8), ((16, 16, 8), 16), ((8, 8, 4), 32))
P19_QUALITY_BATCH = 8
P19_GEN_EVAL_BATCHES = 2
P19_GEN_CONFIG = os.path.join(REPO, "configs", "main_gan_vit_config.yaml")


def p19_imports_and_recurrence(card: str) -> int:
    """(a) every re-exported name, and ``linear_recurrence`` card vs CPU."""
    import importlib

    names = 0
    for sub in ("models", "ops", "data", "parallel", "segmentation",
                "training", "utils", "losses"):
        pkg = importlib.import_module(f"gfe_mamba_torch.{sub}")
        for name in pkg.__all__:
            getattr(pkg, name)
            names += 1
    import gfe_mamba_torch
    getattr(gfe_mamba_torch, "config")
    names += 1
    if names != 90:
        raise AssertionError(f"phase 19(a): {names} re-exported names, "
                             f"expected 90")
    from gfe_mamba_torch.ops.scan import linear_recurrence

    g = torch.Generator().manual_seed(190)
    coeffs = torch.rand(4, 53, 1024, generator=g) * 0.5 + 0.5
    values = torch.randn(4, 53, 1024, generator=g)
    for mode in ("associative", "sequential"):
        want = linear_recurrence(coeffs, values, mode=mode)
        got = linear_recurrence(coeffs.cuda(), values.cuda(), mode=mode)
        check_close(f"(a) linear_recurrence {mode}", got, want, 1e-5,
                    phase=19)
    log(f"phase 19(a): {names} re-exported names resolve; "
        f"linear_recurrence at (4, 53, 1024) in both modes [{card}]")
    return names


def p19_gen_eval(card: str, root: str) -> dict:
    """(b) ``cli/generation_evaluation`` on the card and, for its first
    batch, on the CPU."""
    import argparse

    from gfe_mamba_torch.cli import generation_evaluation
    from gfe_mamba_torch.cli.common import generator_kwargs
    from gfe_mamba_torch.config import load_config
    from gfe_mamba_torch.data.synthetic import make_mri2pet_tree
    from gfe_mamba_torch.models.pipeline import build_generator
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.training.checkpoint import save_params_npz

    cf = dict(load_config(P19_GEN_CONFIG))
    cf["eval_path"] = make_mri2pet_tree(
        os.path.join(root, "gen_eval_tree"),
        n_subjects=P19_GEN_EVAL_BATCHES * cf["eval_bc"],
        shape=tuple(cf["img_sz"]), seed=19)
    config = os.path.join(root, "gen_eval.yaml")
    with open(config, "w") as f:
        f.write(yaml_text(cf))
    ckpt = os.path.join(root, "generator.npz")
    save_params_npz(ckpt, build_generator(
        seed=19, device="cpu", **generator_kwargs(cf, remat_default=False)))

    def run(device, batches, out):
        return generation_evaluation.main(argparse.Namespace(
            config_path=config, ckpt=ckpt, num_batches=batches,
            out_dir=os.path.join(root, out), device=device))

    with tf32_settings(False, False):
        k1.launches = 0
        got = run(None, P19_GEN_EVAL_BATCHES, "gen_eval_card")
        launches = k1.launches
        with plain_convs_on_card():
            witness = run(None, 1, "gen_eval_witness")
        t = time.perf_counter()
        want = run("cpu", 1, "gen_eval_cpu")
        cpu_s = time.perf_counter() - t
    if launches != 10 * P19_GEN_EVAL_BATCHES:
        raise AssertionError(f"phase 19(b): {launches} K1 launches over "
                             f"{P19_GEN_EVAL_BATCHES} batches, expected 10 "
                             f"per batch")
    # the random generator's relu masks flip between two f32 devices, so
    # the kernels are held to the CPU within twice the distance of the
    # same tool on the card with the plain convs (and within 1e-3)
    for key in ("psnr", "mse"):
        a, w, b = got[key][0], witness[key][0], want[key][0]
        dist, witness_dist = abs(a - b) / abs(b), abs(w - b) / abs(b)
        tol = max(1e-3, 2 * witness_dist)
        log(f"phase 19(b) {key}: kernels {a}, plain convs on the card {w}, "
            f"CPU {b}: relative distance {dist:.3e} (witness "
            f"{witness_dist:.3e}, tol {tol:.3e})")
        if not (math.isfinite(a) and dist <= tol):
            raise AssertionError(f"phase 19(b): {key} {a} on the card, {b} "
                                 f"on the CPU")
    pngs = sorted(os.listdir(os.path.join(root, "gen_eval_card")))
    if pngs != [f"{i + 1}.png" for i in range(P19_GEN_EVAL_BATCHES)]:
        raise AssertionError(f"phase 19(b): wrote {pngs}")
    log(f"phase 19(b) generation_evaluation: K1 {launches} launches over "
        f"{P19_GEN_EVAL_BATCHES} batches (f32); batch seconds "
        f"{[round(x, 4) for x in got['seconds']]}; PSNR {got['psnr']} MSE "
        f"{got['mse']}; CPU first batch PSNR {want['psnr'][0]} MSE "
        f"{want['mse'][0]} in {cpu_s:.1f} s [{card}]")
    return dict(k1=launches, seconds=got["seconds"], psnr=got["psnr"],
                mse=got["mse"], tree=cf["eval_path"])


def p19_view_nii(card: str, root: str, tree: str) -> None:
    """(c) ``cli/view_nii --normalize`` against the grid computed here."""
    import numpy as np

    from gfe_mamba_torch.cli import view_nii
    from gfe_mamba_torch.data.nifti import load_nifti
    from gfe_mamba_torch.data.png import read_png
    from gfe_mamba_torch.utils.experiment import volume_grid

    volume = os.path.join(tree, sorted(os.listdir(tree))[0], "mri.nii.gz")
    out = view_nii.main(view_nii.parse_args(
        [volume, "--out", os.path.join(root, "view.png"), "--normalize"]))
    vol = load_nifti(volume)[0]
    lo, hi = np.percentile(vol, [1, 99])
    vol = np.clip((vol - lo) / max(hi - lo, 1e-9), 0, 1) * 2 - 1
    want = (volume_grid(vol) * 255).astype(np.uint8)
    got = read_png(out)[0][..., 0]
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"phase 19(c): the PNG {got.shape} is not the "
                             f"grid {want.shape}")
    log(f"phase 19(c) view_nii: {os.path.basename(volume)} -> grid "
        f"{got.shape}, equal to the CPU's [{card}]")


def p19_against_plain(tag: str, got, want, tol: float = 1e-4) -> float:
    """max |kernel - plain| over max |plain|, within ``tol``; logged."""
    err, _ = rel_err(got, want)
    scale = want.detach().abs().max().item()
    rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
    log(f"phase 19{tag}: kernel vs plain max_abs_err={err:.3e} "
        f"max|plain|={scale:.3e} rel={rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"phase 19{tag}: the kernel disagrees with "
                             f"its plain version: rel {rel}")
    return rel


class _DzCounter:
    """K1's launches inside the conv Function's backward (its dz), read
    from K1's own count around each backward."""

    def __init__(self):
        from gfe_mamba_torch.ops import conv3d
        from gfe_mamba_torch.ops.cuda import conv3d as k1
        self.fn, self.k1, self.count = conv3d.Conv3x3x3Fn, k1, 0
        self.backward = self.fn.backward

    def __enter__(self):
        def backward(ctx, g):
            before = self.k1.launches
            out = self.backward(ctx, g)
            self.count += self.k1.launches - before
            return out

        self.fn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.fn.backward = staticmethod(self.backward)


def p19_counts() -> dict:
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import group_norm as k5
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    return {"K1": k1.launches, "K3": k1.dw_launches, "K2": k2.launches,
            "K4": k2.bwd_launches, "K5a": k5.stats_launches,
            "K5b": k5.apply_launches}


def p19_zero_counts() -> None:
    from gfe_mamba_torch.ops.cuda import conv3d as k1
    from gfe_mamba_torch.ops.cuda import group_norm as k5
    from gfe_mamba_torch.ops.cuda import selective_scan as k2
    k1.launches = k1.dw_launches = k1.dw_mma_launches = 0
    k1.dw_fma_launches = 0
    k2.launches = k2.bwd_launches = 0
    k5.stats_launches = k5.apply_launches = 0


def p19_quality(card: str, root: str) -> dict:
    """(d) ``quality_torch.py --smoke`` at both geometries, its launches
    counted; returns them per geometry and the scan shape of the small
    path's Stage 2."""
    import quality_torch
    from gfe_mamba_torch.ops import scan

    shapes = []
    kernel = scan.selective_scan_cuda

    def recording(x, *args, **kwargs):
        shapes.append(tuple(x.shape) + (args[1].shape[1],))
        return kernel(x, *args, **kwargs)

    out = {}
    for geometry in ("small", "canonical"):
        path = os.path.join(root, f"{geometry}.json")
        scan.selective_scan_cuda = recording
        t = time.perf_counter()
        try:
            with _DzCounter() as dz:
                p19_zero_counts()
                report = quality_torch.main(["--geometry", geometry,
                                             "--smoke", "--out", path])
                counts = p19_counts()
        finally:
            scan.selective_scan_cuda = kernel
        counts["K1-dz"] = dz.count
        counts["K1"] -= dz.count
        wall = time.perf_counter() - t
        for name in ("K1", "K1-dz", "K3", "K2", "K4"):
            if counts[name] <= 0:
                raise AssertionError(f"phase 19(d): {name} never launched "
                                     f"on the {geometry} quality path")
        with open(path) as f:
            if json.load(f)["config"]["smoke"] is not True:
                raise AssertionError("phase 19(d): the artifact is not the "
                                     "smoke run's")
        metrics = report.get("gfe_mamba_torch", report.get("metrics"))
        log(f"phase 19(d) quality_torch --smoke --geometry {geometry}: "
            f"launches {counts}; metrics {metrics}; {wall:.1f} s [{card}]")
        out[geometry] = counts
    return {"launches": out, "small_scan": shapes[0]}


def p19_kernels_at_small_shapes(gen, scan_shape) -> None:
    """(d) K1, K1-dz and K3 (f32) at the small quality path's conv levels,
    K2 and K4 (f32) at its Stage-2 scan shape, against their plain
    versions (1e-4 of the plain result's largest magnitude)."""
    from gfe_mamba_torch.ops.cuda import conv3d as kc
    from gfe_mamba_torch.ops.cuda import selective_scan as ks

    rels = []
    with tf32_settings(False, False):
        for spatial, C in P19_SMALL_LEVELS:
            shape = (P19_QUALITY_BATCH,) + spatial
            for act, with_res, post in (("relu", False, "none"),
                                        ("none", True, "relu")):
                x, w, b, a, s, res = conv_inputs(gen, shape, C, C,
                                                 torch.float32, with_res)
                args = (x, w, b, a, s, res, act, post)
                rels.append(p19_against_plain(
                    f"(d) K1 {shape}x{C} f32 residual={with_res}",
                    kc.conv3x3x3_cuda(*args), kc.conv3x3x3_plain(*args)))
            wf = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            rels.append(p19_against_plain(
                f"(d) K1-dz {shape}x{C} f32", kc.conv3x3x3_cuda(res, wf),
                kc.conv3x3x3_plain(res, wf)))
            rels.append(p19_against_plain(
                f"(d) K3 {shape}x{C} f32", kc.conv3x3x3_dw_cuda(x, res, a, s),
                kc.conv3x3x3_dw_plain(x, res, a, s)))
    bsz, L, ED, N = scan_shape
    args = scan_inputs(gen, bsz, L, ED, N)
    g = torch.randn(bsz, L, ED, generator=gen, device="cuda")
    rels.append(p19_against_plain(
        f"(d) K2 {scan_shape} f32",
        ks.selective_scan_cuda(*args, delta_softplus=True),
        ks.selective_scan_plain(*args, delta_softplus=True)))
    got = ks.selective_scan_bwd_cuda(*args, g, delta_softplus=True)
    want = ks.selective_scan_bwd_plain(*args, g, delta_softplus=True)
    for name, a, b in zip(GRAD_NAMES, got, want):
        rels.append(p19_against_plain(f"(d) K4 {scan_shape} f32 {name}",
                                      a, b))
    log(f"phase 19(d): K1, K1-dz, K3, K2 and K4 at the small quality "
        f"path's shapes within {max(rels):.3e} of their plain versions")


def drive_closing(card: str) -> dict:
    """Phase 19: the public surface, the Stage-1 evaluation and viewer,
    and the quality runs' paths, on the card."""
    t0 = time.perf_counter()
    p19_imports_and_recurrence(card)
    with tempfile.TemporaryDirectory(prefix="gfe_p19_") as root:
        gen_eval = p19_gen_eval(card, root)
        p19_view_nii(card, root, gen_eval["tree"])
        quality = p19_quality(card, root)
    p19_kernels_at_small_shapes(torch.Generator(device="cuda").manual_seed(19),
                                quality["small_scan"])
    torch.cuda.empty_cache()
    log(f"phase 19: {time.perf_counter() - t0:.1f} s of wall [{card}]")
    return dict(gen_eval=gen_eval, quality=quality["launches"])


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

    # the process's own TF32 settings, before the parity checks turn
    # TF32 off: the CLIs of phase 12 run under them, as a user's do
    defaults = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_k1(gen), check_k2(gen)]
    check_pipeline_parity()
    k1_launches, k2_launches, _ = serve_canonical(card)
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
    with tempfile.TemporaryDirectory(prefix="gfe_cli_") as root:
        with tf32_settings(*defaults):
            phase12 = drive_clis(card, root)
        other = drive_other_mixers(card, root, phase12)
        dp = drive_parallel(card, root, phase12)
    seg = drive_segmentation(card)
    other_modules = drive_other_modules(card)
    drive_zoo(card)
    drive_zoo_final(card)
    closing = drive_closing(card)
    kernels[0]["seg_launches"] = seg["launches"]["K1"]
    kernels[0]["seg"] = dict(per="UNet3D forward, 64x128x128, batch 1, f32",
                             version=K1_F32_VERSION,
                             forward_ms=seg["times"]["forward_ms"],
                             **seg["times"]["k1"],
                             **{k: v for k, v in seg["times"]["step"].items()
                                if k.startswith("dz")})
    errors = seg["times"]["errors"]
    (kernels[0]["seg"]["max_abs_err"],
     kernels[0]["seg"]["rel_err"]) = errors["K1"]
    (kernels[0]["seg"]["dz_max_abs_err"],
     kernels[0]["seg"]["dz_rel_err"]) = errors["K1-dz"]
    k3["seg_launches"] = seg["launches"]["K3"]
    k3["seg"] = dict(per="UNet3D training step, batch 1, f32",
                     version=K3_F32_VERSION,
                     ms=seg["times"]["step"]["dw_ms"],
                     tflops=seg["times"]["step"]["dw_tflops"],
                     f32_peak_share=seg["times"]["step"]["dw_f32_peak_share"],
                     plain_ms=seg["times"]["step"]["dw_plain_ms"],
                     library_ms=seg["times"]["step"]["dw_library_ms"],
                     bound_ms=seg["times"]["step"]["dw_bound_ms"],
                     max_abs_err=errors["K3"][0], rel_err=errors["K3"][1])
    kernels[1]["jamba_launches"] = other["k2"]
    kernels[1]["hf_jamba_launches"] = other_modules["hf_jamba"]["launches"]
    kernels[1]["hf_jamba"] = other_modules["hf_jamba"]["k2"]
    k4["jamba_launches"] = other["k4"]
    for k, name in zip(kernels[:2] + [k4, k3], ("K1", "K2", "K4", "K3")):
        k["dp_launches"] = dp[name]
    for k, name in zip(kernels, ("K1", "K2", "K4", "K3", "K5a", "K5b")):
        k["quality_launches"] = {geo: n[name] for geo, n in
                                 closing["quality"].items()}
    kernels[0]["quality_dz_launches"] = {
        geo: n["K1-dz"] for geo, n in closing["quality"].items()}
    kernels[0]["gen_eval_launches"] = closing["gen_eval"]["k1"]
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
