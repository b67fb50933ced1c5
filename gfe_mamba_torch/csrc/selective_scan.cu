// K2: Mamba selective-scan forward.
//
// Replaces the Pallas TPU kernel
// gfe_mamba_tpu/ops/pallas/selective_scan.py::_scan_kernel (launched by
// _forward).  For each (batch b, channel e), with f32 state h[N]:
//
//   d_t  = softplus(delta[b,t,e] + bias[e])          (each step optional)
//   h    = exp(d_t * A[e,:]) * h + (d_t * x[b,t,e]) * B[b,t,:]
//   y    = C[b,t,:] . h + D[e] * x[b,t,e]
//   y   *= silu(z[b,t,e])                            (optional gate)
//
// What bounds it on the H100.  At the serving shape (4, 53, 1024, N = 16)
// it must move ~3.6 MB (x, delta, z in, y out, B, C, A), 0.0011 ms at
// 3.35 TB/s; its ~2e7 f32 operations take less.  Below that lies the
// serial floor of one (b, e, n) walk: one dependent FMA per step, L of
// them, ~0.1 us.  v1 (one thread per (b, e) walking L with dependent
// global loads of x, delta, z in every step, 8 blocks at batch 1) ran at
// roughly one memory round trip per step.
//
// Design (v3; the block and thread split is in scan.cuh: 4 channels x N
// states per block, 1024 blocks at batch 4 and 256 at batch 1):
// - the block walks the sequence in chunks of `chunk` steps (the
//   wrapper's SCAN_CHUNK, 24, or L up to SCAN_WHOLE, 64), and carries each
//   thread's f32 state in a register from one chunk to the next, so
//   shared memory holds one chunk (448 B a step at N = 16) and L has no
//   bound; small chunks keep every block resident (2048 at ED 8192);
// - per chunk it stages x, delta, z for its channels, B and C, with
//   d = softplus(delta + bias) computed while staging;
// - the walk holds one state per thread and carries only its FMA: each
//   group of steps loads its inputs and computes its exps first; it
//   stores h_t for every t of the chunk in shared memory (T (N+1) 4
//   floats);
// - y_t = C_t . h_t + D x_t and the gate then run in parallel over (t, c),
//   reading the stored states, and store y; a barrier frees the chunk's
//   buffers for the next;
// - where `part` is given, each thread writes its last state there:
//   (batch, ED, N) in f32, a prefill's hand-over to the decoding step.
// At L <= SCAN_WHOLE (scoring's 53 steps) this is one chunk: v2's
// staging, walk and shared memory.  What bounds it at document lengths is
// its instructions, not its bytes: an exp and an FMA per (t, e, n) and the
// staging's index arithmetic (6.4 ms at (1, 15024, 8192, 16) against 0.29
// ms of bytes).  v2 staged the whole sequence, which
// capped L at 518 for N = 16 and returned no state.
// bf16 or f32 operands (per operand), with any strides; y is written in
// its own dtype (the caller's: x's), rounded once.

#include "scan.cuh"

#include <stddef.h>

namespace {

constexpr int TILES = 3;  // xs, ds, zs

template <int N>
__global__ void __launch_bounds__(SCAN_CH * N)
scan_kernel(const __grid_constant__ ScanArgs a) {
  constexpr int CH = SCAN_CH, P = (N + 1) * CH;
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, T = a.chunk;
  float* hs = sm;
  float* Bs = hs + T * P;
  float* Cs = Bs + T * N;
  float* xs = Cs + T * N;
  float* dts = xs + T * CH;
  float* zs = dts + T * CH;
  float* Dv = zs + T * CH;

  const int b = blockIdx.y, e0 = blockIdx.x * CH;
  const int c = threadIdx.x % CH, n = threadIdx.x / CH, e = e0 + c;
  const bool gate = a.z.p != nullptr;
  const float an = e < a.ED ? a.A[(size_t)e * N + n] : 0.f;
  float h = 0.f;
  for (int t0 = 0; t0 < L; t0 += T) {
    const int len = min(T, L - t0);
    if (t0 > 0) __syncthreads();  // the last chunk's readers are done
    stage<N>(a, b, e0, t0, len, xs, dts, gate ? zs : nullptr, nullptr,
             nullptr, Bs, Cs, Dv);

    h = forward_walk<N>(len, an, xs, dts, Bs, hs, h);
    __syncthreads();

    for (int i = threadIdx.x; i < len * CH; i += blockDim.x) {
      const int t = i / CH, ci = i % CH;
      if (e0 + ci >= a.ED) continue;
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k)
        y = fmaf(hs[t * P + k * CH + ci], Cs[t * N + k], y);
      y = fmaf(Dv[ci], xs[i], y);
      if (gate) {
        const float zv = zs[i];
        y *= zv / (1.f + expf(-zv));
      }
      st(a.y, b, t0 + t, e0 + ci, y);
    }
  }
  if (a.part && e < a.ED) a.part[((size_t)b * a.ED + e) * N + n] = h;
}

template <int N>
int launch(const ScanArgs& a, cudaStream_t stream) {
  if (a.chunk < 1 || a.chunk > a.L) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_floats<N>(a.chunk, 1, TILES) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would return it
      return (int)err;
    }
  }
  const int nblk = (a.ED + SCAN_CH - 1) / SCAN_CH;
  scan_kernel<N><<<dim3(nblk, a.batch), SCAN_CH * N, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, delta, z (batch, L, ED); B, C (batch, L, N); D, bias (ED,): each f32
// or bf16, with any strides; y: the output, shaped like x; part: the
// final state (batch, ED, N) f32 contiguous, or null.  A (ED, N) f32
// contiguous.  z and bias may be null.  chunk in 1 .. L.  N is one of 4, 8, 16, 32.  Returns
// a cudaError_t code (0 on success).
extern "C" int gfe_selective_scan(const ScanArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (args->N) {
    case 4: return launch<4>(*args, s);
    case 8: return launch<8>(*args, s);
    case 16: return launch<16>(*args, s);
    case 32: return launch<32>(*args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
