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
// Two kernels, chosen by the wrapper on L (ScanArgs::slab):
//
// The short kernel (v3's one chunk; slab 0, L <= SCAN_WHOLE = 64, scoring
// and Stage 2 at (4|1, 53, 1024, 16)).  What bounds it: ~3.6 MB at the
// serving shape, 0.0011 ms at 3.35 TB/s, and the serial floor of one walk,
// L dependent FMAs, ~0.1 us.  The block and thread split is scan.cuh's:
// 4 channels x N states per block (1024 blocks at batch 4, 256 at batch
// 1, a full card); it stages x, delta, z for its channels, B and C, with
// d = softplus(delta + bias) computed while staging, walks with one state
// per thread and stores h_t for every t in shared memory; y_t = C_t . h_t
// + D x_t and the gate then run in parallel over (t, c).  Where `part` is
// given each thread writes its last state there ((batch, ED, N) f32, a
// prefill's hand-over to the decoding step).
//
// The long kernel (v4; slab 64, or 32 at N = 32; L > 64: the Jamba
// prefill's 4,467- to 15,024-token prompts at ED 8192).  What bounds it at
// (1, 15024, 8192, 16) on bf16 views: 0.294 ms of bytes (x, delta, z in, y
// out, B, C); the 1.97e9 (t, e, n) elements, each with one full-precision
// expf, one MUFU ex2 at 16 a clock per SM, ~0.5 ms; and above both the
// instructions issued: ~12 per element for the exp, u = (d x) B and the
// two FMAs, ~15 with the walk's loads and sums, and ~130 per (t, e) for
// loading, the exact softplus and gate and the write-out, ~1.3 ms at 4
// warp-instructions a clock per SM.  v3 took 6.4 ms in 4-channel blocks
// and chunks of 24 steps: each block restaged the same B and C rows, each
// chunk stalled on its loads between two full-block barriers, x came
// channel-major and delta, z, y row-major 8 bytes of a warp's 32 at a
// time, and the y pass re-read 16 stored states per (t, c).  v4:
// - a block owns a slab of 64 channels of one batch row (32 at N = 32)
//   and stages each chunk's B and C once for all of them;
// - its threads split in two roles that meet on mbarriers, with two
//   stages of a chunk (64 steps at N = 16) and two buffers of its y:
//   walkers walk one chunk while stagers write out the y of the one before,
//   load the next and compute its d = softplus(delta + bias) and silu(z);
//   the stagers' loads and long dependent chains (the exact log1p, an IEEE
//   division) wait beside the walkers' exps and FMAs on the same schedulers
//   instead of stalling them, and no barrier holds the whole block;
// - every operand moves coalesced: x, channel-major, a row of steps per
//   channel; delta, z and y a row of the slab's channels per step; x is
//   transposed through shared memory, y leaves through it; offsets inside
//   a chunk are 32-bit (the wrapper copies an operand whose strides would
//   overflow them);
// - each walker keeps LONG_S = 4 states of one channel in registers, the
//   N / 4 walkers of a channel in one warp; their partial C_t . h_t over 4
//   consecutive steps are summed by a transposing butterfly of shuffles
//   that leaves each lane one step's y, to which it adds D x_t, applies
//   the gate and stores it for the write-out; no h_t is stored;
// - a Mamba layer's bf16 operands (softplus, a gate, channel-major x) run
//   an instance with those fixed, and whole chunks of whole slabs go
//   without masks, so the stagers' code has no branch on them.
// The arithmetic is the short kernel's: f32 state, full-precision expf,
// scan.cuh's exact softplus, u = (d x) B, h = fma(exp(d a), h, u), y
// rounded once to its dtype, the last state to `part`; only the order of
// the sum over n differs.
// Both read bf16 or f32 operands (per operand) with any strides; y is
// written in its own dtype (the caller's: x's).

#include "hopper.cuh"
#include "scan.cuh"

#include <stddef.h>

#include <type_traits>

namespace {

// ---- the short kernel: one chunk of L <= SCAN_WHOLE steps ----

constexpr int TILES = 3;  // xs, ds, zs

template <int N>
__global__ void __launch_bounds__(SCAN_CH * N)
scan_kernel(const __grid_constant__ ScanArgs a) {
  constexpr int CH = SCAN_CH, P = (N + 1) * CH;
  extern __shared__ __align__(16) float sm[];
  const int L = a.L;
  float* hs = sm;
  float* Bs = hs + L * P;
  float* Cs = Bs + L * N;
  float* xs = Cs + L * N;
  float* dts = xs + L * CH;
  float* zs = dts + L * CH;
  float* Dv = zs + L * CH;

  const int b = blockIdx.y, e0 = blockIdx.x * CH;
  const int c = threadIdx.x % CH, n = threadIdx.x / CH, e = e0 + c;
  const bool gate = a.z.p != nullptr;
  const float an = e < a.ED ? a.A[(size_t)e * N + n] : 0.f;
  stage<N>(a, b, e0, 0, L, xs, dts, gate ? zs : nullptr, nullptr, nullptr,
           Bs, Cs, Dv);

  const float h = forward_walk<N>(L, an, xs, dts, Bs, hs, 0.f);
  __syncthreads();

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
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
    st(a.y, b, t, e0 + ci, y);
  }
  if (a.part && e < a.ED) a.part[((size_t)b * a.ED + e) * N + n] = h;
}

// ---- the long kernel (v4): a slab of channels, chunks in a pipeline ----

constexpr int LONG_S = 4;    // states per walker
constexpr int LONG_K = 16;   // a chunk's steps per walker of a channel
constexpr int LONG_P = 256;  // stagers per block

// Shared memory of a v4 block: two stages of a chunk (T steps) and two
// buffers of its y.  Rows are padded so that the transposing stores of x
// (a row of steps per thread group) and the walk's accesses of one step
// by the G lanes of a channel fall on distinct banks.
template <int N, int CH>
struct LongSmem {
  static constexpr int G = N / LONG_S, T = LONG_K * G;
  static constexpr int XR = CH + 1;       // (d, x) pairs per step
  static constexpr int YR = CH + 32 / G;  // floats per step of g and y
  struct Stage {
    float2 dx[T * XR];  // d_t and x_t of each channel
    float g[T * YR];    // silu(z_t), or 1 without a gate
    alignas(16) float B[T * N];
    alignas(16) float C[T * N];
  };
  Stage stage[2];
  float y[2][T * YR];
  unsigned long long full[2], empty[2];  // a stage staged; walked
};

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The raw bits of element i of a bf16 (zero-extended) or f32 operand
// from p, through the read-only cache; raw_f32 turns them into the value,
// once all of a chunk's loads are in flight.
__device__ __forceinline__ unsigned ld_raw(const char* p, int bf16, int i) {
  return bf16 ? (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i)
              : __ldg(reinterpret_cast<const unsigned*>(p) + i);
}

__device__ __forceinline__ float raw_f32(unsigned r, int bf16) {
  return __uint_as_float(bf16 ? r << 16 : r);
}

// operand o's element (b, t, e), from which a chunk's 32-bit offsets run
__device__ __forceinline__ const char* elem_ptr(const Operand& o, int b,
                                                int t, int e) {
  return static_cast<const char*>(o.p) +
         ((long long)b * o.sb + (long long)t * o.st + (long long)e * o.se) *
             (o.bf16 ? 2 : 4);
}

// S (a multiple of 4) consecutive floats of shared memory, in 16-byte
// loads
template <int S>
__device__ __forceinline__ void lds(const float* p, float (&v)[S]) {
  static_assert(S % 4 == 0, "whole 16-byte loads");
#pragma unroll
  for (int q = 0; q < S; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + q);
    v[q] = f.x, v[q + 1] = f.y, v[q + 2] = f.z, v[q + 3] = f.w;
  }
}

// Sum p[j] over the G lanes of a channel (lanes g = lane % G), for the G
// steps j at once: each round halves the steps a lane holds, sending the
// half its partner keeps, so lane g ends with step g's sum.
template <int G>
__device__ __forceinline__ float transpose_sum(float (&p)[G], int g) {
#pragma unroll
  for (int w = G / 2; w >= 1; w /= 2) {
    const bool hi = g & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = hi ? p[i] : p[i + w];
      const float keep = hi ? p[i + w] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  return p[0];
}

// Block (blockIdx.x, blockIdx.y) owns channels e0 .. e0 + CH - 1 of batch
// row blockIdx.y; a chunk is T = K G steps; the block's threads split in
// two roles.  The NW = CH G walkers: thread (warp, lane) carries states
// g S .. g S + S - 1 of channel c = warp * 32 / G + lane / G, g = lane %
// G, walks each staged chunk and leaves its y in shared memory.  The
// LONG_P stagers, thread p: item q is channel p % CH of step p / CH + q P
// / CH (row-major operands) or, for a channel-major x, step p % T of
// channel p / T + q P / T; B and C items run over (t, n).  For chunk j
// they write out chunk j - 2's y, once the walkers have left it, then
// load and stage chunk j into the stage the walkers left with chunk j - 2;
// full[s] and empty[s] (mbarriers) pass each stage between the roles.
// Steps past L stage d = 0 and x = 0 (exp(0) = 1 and u = 0 leave h as it
// is), so every chunk walks whole.
template <int N, int CH, bool FAST>
__global__ void __launch_bounds__(CH * N / LONG_S + LONG_P)
scan_long_kernel(const __grid_constant__ ScanArgs a) {
  using Smem = LongSmem<N, CH>;
  using Stage = typename Smem::Stage;
  constexpr int S = LONG_S, G = Smem::G, T = Smem::T, P = LONG_P;
  constexpr int NW = CH * G, XR = Smem::XR, YR = Smem::YR;
  constexpr int Q = T * CH / P;              // row and x items per stager
  constexpr int QB = (T * N + P - 1) / P;    // B (and C) items per stager
  static_assert(N % S == 0 && 32 % G == 0 && NW % 32 == 0 && P % CH == 0 &&
                    P % T == 0 && Q * P == T * CH,
                "a channel's lanes in one warp; whole warps; the stagers' "
                "items tile a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int b = blockIdx.y, e0 = blockIdx.x * CH;
  const int nch = min(CH, a.ED - e0), L = a.L, nk = (L + T - 1) / T;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_addr(&sm.full[s]), P);
      mbar_init(smem_addr(&sm.empty[s]), NW);
    }
  }
  __syncthreads();

  if (tid < NW) {  // walker
    const int lane = tid & 31;
    const int g = lane % G, c = (tid >> 5) * (32 / G) + lane / G;
    float an[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      an[s] = c < nch ? a.A[(size_t)(e0 + c) * N + g * S + s] : 0.f;
      h[s] = 0.f;
    }
    const float Dc = c < nch ? ld(a.D, 0, 0, e0 + c) : 0.f;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(smem_addr(&sm.full[k & 1]), (k >> 1) & 1);
      const Stage& sg = sm.stage[k & 1];
      float* ys = sm.y[k & 1];
#pragma unroll 2
      for (int t = 0; t < T; t += G) {
        float p[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float2 dx = sg.dx[(t + j) * XR + c];
          float bv[S], cv[S];
          lds<S>(&sg.B[(t + j) * N + g * S], bv);
          lds<S>(&sg.C[(t + j) * N + g * S], cv);
          const float du = dx.x * dx.y;
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            h[s] = fmaf(expf(dx.x * an[s]), h[s], du * bv[s]);
            acc = fmaf(h[s], cv[s], acc);
          }
          p[j] = acc;
        }
        float y = transpose_sum<G>(p, g);
        y = fmaf(Dc, sg.dx[(t + g) * XR + c].y, y);
        ys[(t + g) * YR + c] = y * sg.g[(t + g) * YR + c];
      }
      mbar_arrive(smem_addr(&sm.empty[k & 1]));
    }
    if (a.part && c < nch) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        a.part[((size_t)b * a.ED + e0 + c) * N + g * S + s] = h[s];
    }
    return;
  }

  // stager
  const int p = tid - NW;
  const bool gate = FAST || a.z.p != nullptr;
  const bool soft = FAST || a.softplus;
  const int xb = FAST || a.x.bf16, db = FAST || a.delta.bf16;
  const int zb = FAST || a.z.bf16, Bb = FAST || a.B.bf16;
  const int Cb = FAST || a.C.bf16, yb = FAST || a.y.bf16;
  const int rc = p % CH, rt = p / CH;  // row-major items
  // x's items: a row of steps per channel where x is channel-major
  const bool xcm = FAST || a.x.st < a.x.se;
  const int xt = xcm ? p % T : rt, xc = xcm ? p / T : rc;
  const int xdt = xcm ? 0 : P / CH, xdc = xcm ? P / T : 0;
  const float bias = a.bias.p && rc < nch ? ld(a.bias, 0, 0, e0 + rc) : 0.f;
  // 32-bit offsets inside a chunk (the wrapper keeps them below 2^31)
  const int xo = xt * (int)a.x.st + xc * (int)a.x.se;
  const int xd = xdt * (int)a.x.st + xdc * (int)a.x.se;
  const int dlo = rt * (int)a.delta.st + rc * (int)a.delta.se;
  const int dd = P / CH * (int)a.delta.st;
  const int zo = rt * (int)a.z.st + rc * (int)a.z.se;
  const int zd = P / CH * (int)a.z.st;
  const int yo = rt * (int)a.y.st + rc * (int)a.y.se;
  const int yd = P / CH * (int)a.y.st;

  // A whole chunk of a whole slab (every chunk but a sequence's last, in
  // every block but a ragged ED's last) goes without masks: Whole = true.
  // Otherwise items past L or ED load nothing and stage zeros (d = 0 past
  // L) and write nothing out.
  auto flush = [&](auto whole, int j) {
    constexpr bool Whole = decltype(whole)::value;
    const float* ys = sm.y[j & 1];
    char* py = const_cast<char*>(elem_ptr(a.y, b, j * T, e0));
    const int len = min(T, L - j * T);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int t = rt + q * (P / CH);
      if (!Whole && (t >= len || rc >= nch)) continue;
      const float v = ys[t * YR + rc];
      if (yb)
        reinterpret_cast<__nv_bfloat16*>(py)[yo + q * yd] =
            __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(py)[yo + q * yd] = v;
    }
  };
  auto stage = [&](auto whole, int j) {
    constexpr bool Whole = decltype(whole)::value;
    const int t0 = j * T, len = min(T, L - t0);
    const char* px = elem_ptr(a.x, b, t0, e0);
    const char* pd = elem_ptr(a.delta, b, t0, e0);
    const char* pz = gate ? elem_ptr(a.z, b, t0, e0) : nullptr;
    const char* pB = elem_ptr(a.B, b, t0, 0);
    const char* pC = elem_ptr(a.C, b, t0, 0);
    unsigned rx[Q], rd[Q], rz[Q], rB[QB], rC[QB];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool okx =
          Whole || (xt + q * xdt < len && xc + q * xdc < nch);
      rx[q] = okx ? ld_raw(px, xb, xo + q * xd) : 0u;
      const bool ok = Whole || (rt + q * (P / CH) < len && rc < nch);
      rd[q] = ok ? ld_raw(pd, db, dlo + q * dd) : 0u;
      rz[q] = ok && gate ? ld_raw(pz, zb, zo + q * zd) : 0u;
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int i = p + q * P, t = i / N, n = i % N;
      const bool ok = (T * N % P == 0 || i < T * N) && (Whole || t < len);
      rB[q] = ok ? ld_raw(pB, Bb, t * (int)a.B.st + n * (int)a.B.se) : 0u;
      rC[q] = ok ? ld_raw(pC, Cb, t * (int)a.C.st + n * (int)a.C.se) : 0u;
    }
    Stage& sg = sm.stage[j & 1];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int t = rt + q * (P / CH);
      const float v = raw_f32(rd[q], db) + bias;
      const float d = soft ? softplus(v) : v;
      sg.dx[t * XR + rc].x = Whole || t < len ? d : 0.f;
      float gz = 1.f;
      if (gate) {
        const float zv = raw_f32(rz[q], zb);
        gz = zv / (1.f + expf(-zv));
      }
      sg.g[t * YR + rc] = gz;
      sg.dx[(xt + q * xdt) * XR + xc + q * xdc].y = raw_f32(rx[q], xb);
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int i = p + q * P;
      if (T * N % P == 0 || i < T * N) {
        sg.B[i] = raw_f32(rB[q], Bb);
        sg.C[i] = raw_f32(rC[q], Cb);
      }
    }
  };
  const std::true_type whole{};
  const std::false_type ragged{};
  for (int j = 0; j < nk + 2; ++j) {
    if (j >= 2) {  // chunk j - 2's y, once the walkers have left it
      mbar_wait(smem_addr(&sm.empty[j & 1]), ((j - 2) >> 1) & 1);
      if (nch == CH && j - 1 < nk)
        flush(whole, j - 2);
      else
        flush(ragged, j - 2);
    }
    if (j >= nk) continue;
    if (nch == CH && j + 1 < nk)
      stage(whole, j);
    else
      stage(ragged, j);
    mbar_arrive(smem_addr(&sm.full[j & 1]));
  }
}

// ---- the launch ----

// A K2 launch: the kernel, its grid and block, its dynamic shared memory.
struct Launch {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;
};

template <int N>
Launch short_launch(const ScanArgs& a) {
  return {(const void*)scan_kernel<N>,
          dim3((a.ED + SCAN_CH - 1) / SCAN_CH, a.batch), SCAN_CH * N,
          scan_smem_floats<N>(a.L, 1, TILES) * sizeof(float)};
}

template <int N, int CH, bool FAST>
Launch long_launch(const ScanArgs& a) {
  return {(const void*)scan_long_kernel<N, CH, FAST>,
          dim3((a.ED + CH - 1) / CH, a.batch),
          CH * LongSmem<N, CH>::G + LONG_P, sizeof(LongSmem<N, CH>)};
}

// The main path's operands (a Mamba layer in bf16: softplus, a gate, x,
// delta, z, B, C and y bf16, x channel-major) take an instance with those
// fixed, so that the stagers' code has no branch on them; any other mix
// takes the general one.  The slab is the state size's: 64 channels, or
// 32 at N = 32, whose slab of 64 would not fit a block.
template <int N>
Launch pick(const ScanArgs& a) {
  constexpr int CH = N <= 16 ? 64 : 32;
  if (a.slab == 0) return short_launch<N>(a);
  if (a.slab != CH) return {};
  const bool fast = a.softplus && a.z.p && a.x.bf16 && a.delta.bf16 &&
                    a.z.bf16 && a.B.bf16 && a.C.bf16 && a.y.bf16 &&
                    a.x.st < a.x.se;
  return fast ? long_launch<N, CH, true>(a) : long_launch<N, CH, false>(a);
}

// The launch for `a`; its kernel is null where `a` names none.
Launch pick(const ScanArgs& a) {
  switch (a.N) {
    case 4: return pick<4>(a);
    case 8: return pick<8>(a);
    case 16: return pick<16>(a);
    case 32: return pick<32>(a);
    default: return {};
  }
}

// Raises the kernel's limit of dynamic shared memory to what the launch
// needs, and only past the default 48 KB, so that no launch or query
// lowers it below what a later launch of the same kernel needs.
cudaError_t prepare(const Launch& k) {
  if (!k.kernel) return cudaErrorInvalidValue;
  if (k.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)k.smem);
}

}  // namespace

// x, delta, z (batch, L, ED); B, C (batch, L, N); D, bias (ED,): each f32
// or bf16, with any strides; y: the output, shaped like x; part: the
// final state (batch, ED, N) f32 contiguous, or null.  A (ED, N) f32
// contiguous.  z and bias may be null.  N is one of 4, 8, 16, 32.  slab 0
// runs the short kernel; 64 (N <= 16) or 32 (N = 32) the long one.
// Returns a cudaError_t code (0 on success).
extern "C" int gfe_selective_scan(const ScanArgs* args, void* stream) {
  const Launch k = pick(*args);
  cudaError_t err = prepare(k);
  if (err == cudaSuccess) {
    void* params[] = {const_cast<ScanArgs*>(args)};
    err = cudaLaunchKernel(k.kernel, k.grid, dim3(k.threads), params,
                           k.smem, static_cast<cudaStream_t>(stream));
  }
  if (err != cudaSuccess) cudaGetLastError();  // or the next launch sees it
  return (int)err;
}

// The resident blocks per SM of the kernel gfe_selective_scan would
// launch for these arguments (pointers unread), into *blocks.
extern "C" int gfe_selective_scan_occupancy(const ScanArgs* args,
                                            int* blocks) {
  const Launch k = pick(*args);
  cudaError_t err = prepare(k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k.kernel,
                                                        k.threads, k.smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
