// K4: Mamba selective-scan backward.
//
// Replaces the Pallas TPU kernel
// gfe_mamba_tpu/ops/pallas/selective_scan.py::_bwd_kernel (launched by
// _backward).  For each (batch b, channel e), with f32 state h[N] and the
// cotangent g of y:
//
//   pass 1  h_t = exp(d_t A) h_{t-1} + d_t x_t B_t,   t = 0 .. L-1
//   pass 2  t = L-1 .. 0, carrying dh (pre-scaled by exp(d_{t+1} A)):
//           ds    = g_t silu(z_t)            (g_t without a gate)
//           dz_t  = g_t s_t sig(z_t) (1 + z_t (1 - sig(z_t))),
//                   s_t = C_t . h_t + D x_t
//           dh   += C_t ds
//           dx_t  = (dh . B_t) d_t + D ds
//           dd_t  = (dh . B_t) x_t + sum_n dh h_{t-1} A exp(d_t A)
//                   (times sigmoid(delta_t + bias) under softplus)
//           dA   += dh h_{t-1} d_t exp(d_t A);  dD += ds x_t;
//           dbias += dd_t
//           dB_t  = sum_e dh d_t x_t;  dC_t = sum_e h_t ds
//           dh   *= exp(d_t A)
//
// What bounds it on the H100: at the Stage-2 shape (1, 53, 1024, N = 16)
// it reads and writes ~1.5 MB and does ~1e7 operations, so memory and
// arithmetic allow a few microseconds; the two sequential walks over L
// and the launch set its time, as for K2.
//
// Design: one thread per (b, e), as in K2, with B_t and C_t for the whole
// sequence staged once per block in shared memory.  h over all L does not
// fit in registers (L * N floats per thread), so pass 1 writes h_t to a
// global scratch laid out (B, L, N, ED), coalesced over e; pass 2 reads
// h_{t-1} back from it and keeps h_t, dh[N] and dA[N] in registers.  dB
// and dC reduce over channels: each warp sums its 32 lanes with shuffles
// and writes one partial per (batch, warp, t, n); the caller sums the
// partials over warps in a fixed order, so the result is deterministic.
// dA, dD and dbias are written per (batch, channel) and summed over batch
// by the caller.  Threads past a ragged ED take part in the shuffles with
// zero inputs, which contribute nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__global__ void __launch_bounds__(NTHREADS)
scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ z, const float* __restrict__ bias,
                const float* __restrict__ g, float* __restrict__ hbuf,
                float* __restrict__ dx, float* __restrict__ ddelta,
                float* __restrict__ dz, float* __restrict__ da_part,
                float* __restrict__ daux, float* __restrict__ db_part,
                float* __restrict__ dc_part, int L, int ED, int softplus_on) {
  extern __shared__ float bc[];  // B then C, each (L, N)
  const int b = blockIdx.y;
  const int e = blockIdx.x * NTHREADS + threadIdx.x;
  const bool valid = e < ED;
  const int lane = threadIdx.x % 32;
  const int nwarps = gridDim.x * NWARPS;
  const int warp = blockIdx.x * NWARPS + threadIdx.x / 32;
  const size_t bc_off = (size_t)b * L * N;
  for (int i = threadIdx.x; i < L * N; i += NTHREADS) {
    bc[i] = Bm[bc_off + i];
    bc[L * N + i] = Cm[bc_off + i];
  }
  __syncthreads();

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = valid ? A[(size_t)e * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float d_skip = valid ? D[e] : 0.f;
  const float d_bias = (valid && bias != nullptr) ? bias[e] : 0.f;
  // h_t of (b, t) sits at hbuf[((b * L + t) * N + n) * ED + e]
  float* hb = hbuf + (size_t)b * L * N * ED + e;

  // pass 1: recompute the states
  for (int t = 0; t < L; ++t) {
    const size_t o = ((size_t)b * L + t) * ED + e;
    const float xv = valid ? x[o] : 0.f;
    float d = (valid ? delta[o] : 0.f) + d_bias;
    if (softplus_on) d = softplus(d);
    const float dxv = d * xv;
    const float* Bt = bc + t * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = expf(d * a[n]) * h[n] + dxv * Bt[n];
      if (valid) hb[((size_t)t * N + n) * ED] = h[n];
    }
  }

  // pass 2: reverse-time gradient recurrence; h holds h_t
  float dh[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) dh[n] = da[n] = 0.f;
  float d_d = 0.f, d_b = 0.f;
  for (int t = L - 1; t >= 0; --t) {
    const size_t o = ((size_t)b * L + t) * ED + e;
    const float xv = valid ? x[o] : 0.f;
    const float gv = valid ? g[o] : 0.f;
    const float raw = (valid ? delta[o] : 0.f) + d_bias;
    const float d = softplus_on ? softplus(raw) : raw;
    const float* Bt = bc + t * N;
    const float* Ct = bc + L * N + t * N;
    float ds = gv;
    if (z != nullptr) {
      const float zv = valid ? z[o] : 0.f;
      float s = d_skip * xv;
#pragma unroll
      for (int n = 0; n < N; ++n) s = fmaf(h[n], Ct[n], s);
      const float sig = sigmoid(zv);
      ds = gv * zv * sig;
      if (valid) dz[o] = gv * s * (sig * (1.f + zv * (1.f - sig)));
    }
    float dh_b = 0.f, dh_a = 0.f;
    const float dxv = d * xv;
    float* db_row = db_part + (((size_t)b * nwarps + warp) * L + t) * N;
    float* dc_row = dc_part + (((size_t)b * nwarps + warp) * L + t) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float hp = (t > 0 && valid) ? hb[((size_t)(t - 1) * N + n) * ED]
                                        : 0.f;
      const float ea = expf(d * a[n]);
      dh[n] = fmaf(Ct[n], ds, dh[n]);
      dh_b = fmaf(dh[n], Bt[n], dh_b);
      const float dhp = dh[n] * hp;
      dh_a = fmaf(dhp * a[n], ea, dh_a);
      da[n] = fmaf(dhp * d, ea, da[n]);
      const float db_sum = warp_sum(dh[n] * dxv);
      const float dc_sum = warp_sum(h[n] * ds);
      if (lane == 0) {
        db_row[n] = db_sum;
        dc_row[n] = dc_sum;
      }
      dh[n] *= ea;
      h[n] = hp;
    }
    float dd = dh_b * xv + dh_a;
    if (softplus_on) dd *= sigmoid(raw);
    d_b += dd;
    d_d = fmaf(ds, xv, d_d);
    if (valid) {
      dx[o] = fmaf(dh_b, d, d_skip * ds);
      ddelta[o] = dd;
    }
  }
  if (!valid) return;
#pragma unroll
  for (int n = 0; n < N; ++n) da_part[((size_t)b * N + n) * ED + e] = da[n];
  daux[((size_t)b * 2) * ED + e] = d_d;
  daux[((size_t)b * 2 + 1) * ED + e] = d_b;
}

template <int N>
int launch(const float* x, const float* delta, const float* A,
           const float* Bm, const float* Cm, const float* D, const float* z,
           const float* bias, const float* g, float* hbuf, float* dx,
           float* ddelta, float* dz, float* da_part, float* daux,
           float* db_part, float* dc_part, int batch, int L, int ED,
           int softplus, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)L * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((ED + NTHREADS - 1) / NTHREADS, batch);
  scan_bwd_kernel<N><<<grid, NTHREADS, smem, stream>>>(
      x, delta, A, Bm, Cm, D, z, bias, g, hbuf, dx, ddelta, dz, da_part,
      daux, db_part, dc_part, L, ED, softplus);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors float32 and contiguous: x, delta, z, g, dx, ddelta, dz
// (batch, L, ED); A (ED, N); B, C (batch, L, N); D, bias (ED,); hbuf
// (batch, L, N, ED) scratch; da_part (batch, N, ED); daux (batch, 2, ED)
// (dD then dbias); db_part, dc_part (batch, nwarps, L, N) with nwarps =
// 4 * ceil(ED / 128).  z/dz and bias may be null.  N is one of 4, 8, 16,
// 32.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_selective_scan_bwd(
    const float* x, const float* delta, const float* A, const float* Bm,
    const float* Cm, const float* D, const float* z, const float* bias,
    const float* g, float* hbuf, float* dx, float* ddelta, float* dz,
    float* da_part, float* daux, float* db_part, float* dc_part, int batch,
    int L, int ED, int N, int softplus, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GFE_SCAN_BWD(NN)                                                     \
  return launch<NN>(x, delta, A, Bm, Cm, D, z, bias, g, hbuf, dx, ddelta,    \
                    dz, da_part, daux, db_part, dc_part, batch, L, ED,       \
                    softplus, st)
  switch (N) {
    case 4: GFE_SCAN_BWD(4);
    case 8: GFE_SCAN_BWD(8);
    case 16: GFE_SCAN_BWD(16);
    case 32: GFE_SCAN_BWD(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GFE_SCAN_BWD
}
