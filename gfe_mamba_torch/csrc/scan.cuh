// What K2 (selective_scan.cu) and K4 (selective_scan_bwd.cu) share: the
// operand descriptors of the C interface, bf16/f32 loads and stores, the
// staging of a block's tiles into shared memory and the forward walk (K2's
// short kernel, up to 64 steps; its long kernel has its own).
//
// Work split.  A block owns SCAN_CH channels of one batch row and all L
// steps; it has SCAN_CH * N threads, thread (c, n) = (tid % CH, tid / CH)
// carrying state n of channel c.  So the grid is (ceil(ED / CH), batch):
// 256 blocks at the Stage-2 shape (1, 53, 1024, 16), one at least for each
// of the H100's 132 SMs.  A block first stages everything its walks read
// over a window of steps (x, delta, z, g for its channels, B and C of its
// batch row), each thread issuing its loads in batches ahead of their
// stores, all before one barrier, and computes d = softplus(delta + bias)
// there, outside the walks.  Both stage the whole sequence at once.
//
// State buffers hold one value per (t, n, c), laid out [t][n][c] with a
// step stride of P = (N + 1) * CH floats: in a walk the block's threads
// touch one step's N * CH consecutive floats, and a pass over (t, c)
// reading n = 0 .. N-1 hits distinct banks for the 32 / CH steps of a
// warp (P = CH mod 32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>


// A (batch, L, width) tensor, or a (width,) vector (sb = st = 0), f32 or
// bf16, with any strides: x comes channel-major from the depthwise conv,
// z and B, C are views into the projections' outputs.  A null p means
// absent.
struct Operand {
  const void* p;
  long long sb, st, se;  // batch, time and last-dimension strides (elements)
  int bf16, pad;
};

// Packed byte for byte by ``_args`` in ops/cuda/selective_scan.py (488
// bytes).  Both structs stay outside the anonymous namespace: the C entry
// points that take them are exported.
struct ScanArgs {
  Operand x, delta, z, B, C, D, bias, g;  // inputs; z, bias, g may be null
  Operand y, ddelta, dz;  // outputs: K2's y, or K4's dx, ddelta, dz
  const float* A;         // (ED, N) f32, contiguous
  float* part;            // K2: the final state (batch, ED, N) f32, or
                          // null; K4: per-block partials (scratch)
  float* grads;           // K4: dB, dC, dA, dD, dbias in f32
  int batch, L, ED, N, softplus;
  int slab;               // K2: 0, the short kernel, or the long kernel's
                          // channels per block (64; 32 at N = 32)
};
static_assert(sizeof(Operand) == 40 && sizeof(ScanArgs) == 488,
              "the layout _args packs in ops/cuda/selective_scan.py");

namespace {

constexpr int SCAN_CH = 4;      // channels per block
constexpr int SCAN_UNROLL = 4;  // steps whose loads and exps issue together

__device__ __forceinline__ float ld(const Operand& o, int b, int t, int e) {
  const long long i = (long long)b * o.sb + (long long)t * o.st + e * o.se;
  return o.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(o.p)[i])
                : static_cast<const float*>(o.p)[i];
}

// rounds once, to nearest even, when the operand is bf16
__device__ __forceinline__ void st(const Operand& o, int b, int t, int e,
                                   float v) {
  const long long i = (long long)b * o.sb + (long long)t * o.st + e * o.se;
  if (o.bf16)
    static_cast<__nv_bfloat16*>(const_cast<void*>(o.p))[i] =
        __float2bfloat16_rn(v);
  else
    static_cast<float*>(const_cast<void*>(o.p))[i] = v;
}

// log(1 + exp(v)) as max(v, 0) + log1p(exp(-|v|)): jax.nn.softplus's
// exact form, no threshold shortcut
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Stage steps t0 .. t0 + T - 1 of the block's tiles, each (T, CH) and
// indexed (t - t0) * CH + c: xs = x,
// ds = d_t, zs = z (if zs), gs = g (if gs), sg = sigmoid(delta + bias)
// under softplus and 1 without (if sg); Bs, Cs (L, N) of batch row b; Dv
// (CH).  Channels past ED stage zeros, so their states and gradients stay
// 0.  A thread issues the global loads of STAGE_BATCH elements before it
// stores any of them: a store to shared memory may alias a generic
// pointer, so the compiler would otherwise wait for each load in turn.
// Ends with a barrier.
constexpr int STAGE_BATCH = 8;

template <int N>
__device__ __forceinline__ void stage(const ScanArgs& a, int b, int e0,
                                      int t0, int T, float* xs, float* ds,
                                      float* zs, float* gs, float* sg,
                                      float* Bs, float* Cs, float* Dv) {
  const int L = T, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < L * SCAN_CH; i0 += STAGE_BATCH * step) {
    float vx[STAGE_BATCH], vd[STAGE_BATCH], vz[STAGE_BATCH],
        vg[STAGE_BATCH];
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int i = i0 + k * step, t = t0 + i / SCAN_CH,
                e = e0 + i % SCAN_CH;
      const bool valid = i < L * SCAN_CH && e < a.ED;
      vx[k] = valid ? ld(a.x, b, t, e) : 0.f;
      vd[k] = valid ? ld(a.delta, b, t, e) +
                          (a.bias.p ? ld(a.bias, 0, 0, e) : 0.f)
                    : 0.f;
      vz[k] = valid && zs ? ld(a.z, b, t, e) : 0.f;
      vg[k] = valid && gs ? ld(a.g, b, t, e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int i = i0 + k * step;
      if (i >= L * SCAN_CH) break;
      xs[i] = vx[k];
      ds[i] = a.softplus ? softplus(vd[k]) : vd[k];
      if (zs) zs[i] = vz[k];
      if (gs) gs[i] = vg[k];
      if (sg) sg[i] = a.softplus ? sigmoid(vd[k]) : 1.f;
    }
  }
  for (int i0 = threadIdx.x; i0 < L * N; i0 += STAGE_BATCH * step) {
    float vb[STAGE_BATCH], vc[STAGE_BATCH];
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int i = min(i0 + k * step, L * N - 1);
      vb[k] = ld(a.B, b, t0 + i / N, i % N);
      vc[k] = ld(a.C, b, t0 + i / N, i % N);
    }
#pragma unroll
    for (int k = 0; k < STAGE_BATCH; ++k) {
      const int i = i0 + k * step;
      if (i >= L * N) break;
      Bs[i] = vb[k];
      Cs[i] = vc[k];
    }
  }
  if (threadIdx.x < SCAN_CH)
    Dv[threadIdx.x] = e0 + (int)threadIdx.x < a.ED
                          ? ld(a.D, 0, 0, e0 + threadIdx.x) : 0.f;
  __syncthreads();
}

// The forward walk of thread (c, n) over L staged steps from the state
// h: h_t = exp(d_t a) h_{t-1} + d_t x_t B_t[n] into hs[t * P + tid],
// t = 0 .. L-1; returns the last h.  Only the FMA carries from one step to
// the next: each group of SCAN_UNROLL steps loads its inputs and computes
// its exps before its chain of FMAs.
template <int N>
__device__ __forceinline__ float forward_walk(int L, float a, const float* xs,
                                              const float* ds,
                                              const float* Bs, float* hs,
                                              float h) {
  constexpr int P = (N + 1) * SCAN_CH;
  const int tid = threadIdx.x, c = tid % SCAN_CH, n = tid / SCAN_CH;
  for (int t0 = 0; t0 < L; t0 += SCAN_UNROLL) {
    float ea[SCAN_UNROLL], u[SCAN_UNROLL];
#pragma unroll
    for (int k = 0; k < SCAN_UNROLL; ++k) {
      const int t = min(t0 + k, L - 1);
      const float d = ds[t * SCAN_CH + c];
      ea[k] = expf(d * a);
      u[k] = d * xs[t * SCAN_CH + c] * Bs[t * N + n];
    }
#pragma unroll
    for (int k = 0; k < SCAN_UNROLL; ++k) {
      if (t0 + k < L) {
        h = fmaf(ea[k], h, u[k]);
        hs[(t0 + k) * P + tid] = h;
      }
    }
  }
  return h;
}

// shared memory of a block, in floats: `states` state buffers (L * P
// each), `tiles` (L, CH) tiles, B and C, D
template <int N>
constexpr size_t scan_smem_floats(int L, int states, int tiles) {
  return (size_t)L * ((size_t)states * (N + 1) * SCAN_CH + 2 * N +
                      (size_t)tiles * SCAN_CH) + SCAN_CH;
}

}  // namespace
