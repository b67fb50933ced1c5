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
// What bounds it on the H100.  At the Stage-2 shape (1, 53, 1024, N = 16)
// it must move ~1.5 MB (x, delta, z, g in; dx, ddelta, dz out; A, B, C
// and their gradients), 0.0005 ms at 3.35 TB/s, and its ~2e7 f32
// operations take less.  Below that lies the serial floor of one (b, e, n)
// walk: pass 1 carries one FMA per step, pass 2 an FMA and a multiply, so
// 3 * L dependent operations of ~4 cycles, ~0.3 us.  What v1 lost was the
// rest: 8 blocks at batch 1, dependent global loads in every step, a
// global h_buf (3.5 MB per call) and 32 warp reductions inside the walk.
//
// Design (v2; the block and thread split is in scan.cuh: 4 channels x N
// states per block, 256 blocks at batch 1):
// - the block stages x, delta, z, g for its channels and the whole
//   sequence, B and C, with d = softplus(delta + bias) and its sigmoid
//   computed while staging;
// - pass 1 keeps h_t for every t in shared memory (L (N+1) 4 floats per
//   buffer, 14.4 KB at the Stage-2 shape); no global scratch;
// - what needs no carried state runs between the walks, in parallel over
//   (t, c) or (t, n): s_t, ds and dz after pass 1; dh . B_t, the dd sum,
//   dx and dd after pass 2, from dh_t which pass 2 stores per step;
// - the walks hold one state per thread, so they have no reductions: pass
//   2 stores dh_t and w_t = dh_t h_{t-1} exp(d_t A) A (into h_{t-1}'s
//   slot, which nothing reads again) and accumulates dA;
// - dB and dC are summed over the block's channels in a fixed order after
//   the walks and written as per-block partials; a second kernel sums
//   them over blocks, dA, dD and dbias over batch, all in a fixed order
//   (no atomics), into one f32 buffer: one launch for the caller's four
//   reductions.
// bf16 or f32 operands (per operand), with any strides; dx, ddelta, dz
// are written in x's, delta's and z's dtype, rounded once.

#include "scan.cuh"

#include <stddef.h>

namespace {

constexpr int TILES = 6;  // xs, ds, zs, gs (then ds of s), sg, dd

template <int N>
__global__ void __launch_bounds__(SCAN_CH * N)
scan_bwd_kernel(const __grid_constant__ ScanArgs a) {
  constexpr int CH = SCAN_CH, P = (N + 1) * CH;
  extern __shared__ __align__(16) float sm[];
  const int L = a.L;
  float* hs = sm;            // h_t, then w_t at slot t - 1
  float* dhs = hs + L * P;   // dh_t
  float* Bs = dhs + L * P;
  float* Cs = Bs + L * N;
  float* xs = Cs + L * N;
  float* dts = xs + L * CH;  // d_t
  float* zs = dts + L * CH;
  float* gs = zs + L * CH;   // g, then the gradient of s: ds
  float* sg = gs + L * CH;
  float* dds = sg + L * CH;
  float* Dv = dds + L * CH;

  const int b = blockIdx.y, blk = blockIdx.x, e0 = blk * CH;
  const int tid = threadIdx.x, c = tid % CH, n = tid / CH, e = e0 + c;
  const bool valid = e < a.ED;
  const bool gate = a.z.p != nullptr;
  const float an = valid ? a.A[(size_t)e * N + n] : 0.f;
  stage<N>(a, b, e0, 0, L, xs, dts, gate ? zs : nullptr, gs, sg, Bs, Cs,
           Dv);

  forward_walk<N>(L, an, xs, dts, Bs, hs, 0.f);
  __syncthreads();

  // s_t, ds and dz, over (t, c)
  for (int i = tid; i < L * CH; i += blockDim.x) {
    const int t = i / CH, ci = i % CH;
    const float gv = gs[i];
    float dsv = gv;
    if (gate) {
      float s = Dv[ci] * xs[i];
#pragma unroll
      for (int k = 0; k < N; ++k) s = fmaf(hs[t * P + k * CH + ci],
                                           Cs[t * N + k], s);
      const float zv = zs[i], sig = sigmoid(zv);
      dsv = gv * zv * sig;
      if (e0 + ci < a.ED)
        st(a.dz, b, t, e0 + ci, gv * s * (sig * (1.f + zv * (1.f - sig))));
    }
    gs[i] = dsv;
  }
  __syncthreads();

  // dC_t[n] = sum over the block's channels of h_t ds_t, over (t, n)
  float* part = a.part + ((size_t)b * gridDim.x + blk) * 2 * L * N;
  for (int i = tid; i < L * N; i += blockDim.x) {
    const int t = i / N, k = i % N;
    float acc = 0.f;
#pragma unroll
    for (int ci = 0; ci < CH; ++ci)
      acc = fmaf(hs[t * P + k * CH + ci], gs[t * CH + ci], acc);
    part[L * N + i] = acc;
  }
  __syncthreads();

  // pass 2: only dh carries (an FMA and a multiply per step)
  float dh = 0.f, da = 0.f;
  for (int t0 = L - 1; t0 >= 0; t0 -= SCAN_UNROLL) {
    float cds[SCAN_UNROLL], hp[SCAN_UNROLL], ea[SCAN_UNROLL],
        dv[SCAN_UNROLL];
#pragma unroll
    for (int k = 0; k < SCAN_UNROLL; ++k) {
      const int t = max(t0 - k, 0);
      dv[k] = dts[t * CH + c];
      ea[k] = expf(dv[k] * an);
      cds[k] = Cs[t * N + n] * gs[t * CH + c];
      hp[k] = t > 0 ? hs[(t - 1) * P + tid] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SCAN_UNROLL; ++k) {
      const int t = t0 - k;
      if (t >= 0) {
        dh += cds[k];
        dhs[t * P + tid] = dh;
        const float w = dh * hp[k] * ea[k];
        da = fmaf(w, dv[k], da);
        if (t > 0) hs[(t - 1) * P + tid] = w * an;
        dh *= ea[k];
      }
    }
  }
  if (valid) a.part[(size_t)a.batch * gridDim.x * 2 * L * N +
                    ((size_t)b * a.ED + e) * N + n] = da;
  __syncthreads();

  // dx and dd over (t, c); dB_t[n] over (t, n): both read only
  for (int i = tid; i < L * CH; i += blockDim.x) {
    const int t = i / CH, ci = i % CH;
    float dhb = 0.f, dha = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      dhb = fmaf(dhs[t * P + k * CH + ci], Bs[t * N + k], dhb);
      if (t > 0) dha += hs[(t - 1) * P + k * CH + ci];
    }
    const float dd = (dhb * xs[i] + dha) * sg[i];
    dds[i] = dd;
    if (e0 + ci < a.ED) {
      st(a.y, b, t, e0 + ci, fmaf(dhb, dts[i], Dv[ci] * gs[i]));
      st(a.ddelta, b, t, e0 + ci, dd);
    }
  }
  for (int i = tid; i < L * N; i += blockDim.x) {
    const int t = i / N, k = i % N;
    float acc = 0.f;
#pragma unroll
    for (int ci = 0; ci < CH; ++ci)
      acc = fmaf(dhs[t * P + k * CH + ci],
                 dts[t * CH + ci] * xs[t * CH + ci], acc);
    part[i] = acc;
  }
  __syncthreads();

  // dD and dbias of the block's channels, summed over t in order
  if (tid < CH && e0 + tid < a.ED) {
    float d_d = 0.f, d_b = 0.f;
    for (int t = 0; t < L; ++t) {
      d_d = fmaf(gs[t * CH + tid], xs[t * CH + tid], d_d);
      d_b += dds[t * CH + tid];
    }
    float* aux = a.part + (size_t)a.batch * gridDim.x * 2 * L * N +
                 (size_t)a.batch * a.ED * N;
    aux[((size_t)b * 2) * a.ED + e0 + tid] = d_d;
    aux[((size_t)b * 2 + 1) * a.ED + e0 + tid] = d_b;
  }
}

// Sums the partials in a fixed order into grads: dB (batch, L, N), dC
// (batch, L, N), dA (ED, N), dD (ED), dbias (ED).  A block takes 32
// consecutive outputs; its FINISH_GROUPS warps sum every FINISH_GROUPS-th
// block's dB/dC partial from a different start (loads coalesced over the
// outputs), then warp 0 adds the groups in order.
constexpr int FINISH_GROUPS = 8;

__global__ void __launch_bounds__(32 * FINISH_GROUPS)
finish_kernel(const float* __restrict__ part, float* __restrict__ grads,
              int batch, int nblk, int L, int N, int ED) {
  __shared__ float red[FINISH_GROUPS][32];
  const size_t LN = (size_t)L * N, nbc = 2 * (size_t)batch * LN;
  const size_t nda = (size_t)ED * N, total = nbc + nda + 2 * (size_t)ED;
  const float* da_part = part + (size_t)batch * nblk * 2 * LN;
  const float* aux = da_part + (size_t)batch * nda;
  const int o = threadIdx.x % 32, grp = threadIdx.x / 32;
  const size_t j = (size_t)blockIdx.x * 32 + o;
  float acc = 0.f;
  if (j < nbc) {
    const size_t s = j / (batch * LN), r = j % (batch * LN);
    const float* p = part + ((r / LN) * nblk * 2 + s) * LN + r % LN;
#pragma unroll 8
    for (int k = grp; k < nblk; k += FINISH_GROUPS)
      acc += p[(size_t)k * 2 * LN];
  } else if (j < nbc + nda && grp == 0) {
    for (int b = 0; b < batch; ++b) acc += da_part[b * nda + (j - nbc)];
  } else if (j < total && grp == 0) {
    const size_t r = j - nbc - nda;  // dD then dbias
    for (int b = 0; b < batch; ++b) acc += aux[b * 2 * (size_t)ED + r];
  }
  red[grp][o] = acc;
  __syncthreads();
  if (grp == 0 && j < total) {
#pragma unroll
    for (int g = 1; g < FINISH_GROUPS; ++g) acc += red[g][o];
    grads[j] = acc;
  }
}

template <int N>
int launch(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = scan_smem_floats<N>(a.L, 2, TILES) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would return it
      return (int)err;
    }
  }
  const int nblk = (a.ED + SCAN_CH - 1) / SCAN_CH;
  scan_bwd_kernel<N><<<dim3(nblk, a.batch), SCAN_CH * N, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = 2 * (size_t)a.batch * a.L * N + (size_t)a.ED * N +
                       2 * (size_t)a.ED;
  finish_kernel<<<(unsigned)((total + 31) / 32), 32 * FINISH_GROUPS, 0,
                  stream>>>(a.part, a.grads, a.batch, nblk, a.L, N, a.ED);
  return (int)cudaGetLastError();
}

}  // namespace

// x, delta, z, g (batch, L, ED); B, C (batch, L, N); D, bias (ED,): each
// f32 or bf16, with any strides.  y (dx), ddelta, dz: outputs shaped like
// x.  A (ED, N) f32 contiguous.  part: scratch of
// gfe_selective_scan_bwd_scratch(batch, L, ED, N) floats; grads: dB, dC,
// dA, dD, dbias back to back, 2 * batch * L * N + ED * N + 2 * ED floats.
// z/dz and bias may be null.  N is one of 4, 8, 16, 32.  Returns a
// cudaError_t code (0 on success).
extern "C" int gfe_selective_scan_bwd(const ScanArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->N) {
    case 4: return launch<4>(*args, s);
    case 8: return launch<8>(*args, s);
    case 16: return launch<16>(*args, s);
    case 32: return launch<32>(*args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Floats of the scratch `part`: per-block dB/dC partials, then
// per-(batch, channel) dA, then dD and dbias.
extern "C" long long gfe_selective_scan_bwd_scratch(int batch, int L, int ED,
                                                    int N) {
  const long long nblk = (ED + SCAN_CH - 1) / SCAN_CH;
  return (long long)batch * (nblk * 2 * L * N + (long long)ED * N + 2 * ED);
}
