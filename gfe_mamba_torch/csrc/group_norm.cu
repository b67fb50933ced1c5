// K5a and K5b: the two passes of GroupNorm + activation over a
// channels-last x viewed as (B, S, C).
//
// Replaces the Pallas TPU kernels
// gfe_mamba_tpu/ops/pallas/group_norm.py::_stats_kernel (K5a) and
// ::_apply_kernel (K5b), both launched by _forward there:
//
//   K5a  part[b, split, 0, c] = sum over the split's rows s of x[b,s,c]
//        part[b, split, 1, c] = sum of x[b,s,c]^2                   (f32)
//   K5b  y = (x - mean[b,c]) * inv[b,c] * scale[c] + bias[c]        (f32)
//        y = act(y): none, elu (y > 0 ? y : exp(min(y, 0)) - 1), relu,
//        leaky relu with slope 0.01; stored in x's dtype
//
// The fold of the per-channel sums into group statistics between the two
// passes is a few hundred floats and stays in PyTorch, as it stays in XLA
// in the JAX package; so does the sum over the splits, in a fixed order.
//
// What bounds them on the H100: both are pure streams.  K5a reads x once
// (1.26 GB at (4,160,160,96,64) bf16, 0.38 ms at 3.35 TB/s) and does two
// flops per element; K5b reads and writes it once (0.75 ms).  The
// operation count is far below the memory line, so bytes set the pace.
//
// Design, shared by both: a block of 256 threads covers up to 256 16-byte
// channel vectors of a row (8 bf16 or 4 f32 channels each) and as many
// rows at once as the rest of its threads allow; grid (splits, B, channel
// blocks).  Each thread keeps one channel vector for the whole split and
// walks the split's rows with a stride of the block's row lanes, so its
// per-channel constants (K5b: mean, inv, scale, bias) live in registers
// and every warp reads contiguous 16-byte vectors.  K5a accumulates in
// f32 registers, then reduces the row lanes in shared memory in a fixed
// order and writes one (2, C) partial per block: no float atomics, so the
// result is deterministic.  When C * itemsize is not a multiple of 16 or
// a pointer is not 16-byte aligned, the same kernels run with one channel
// per thread (scalar loads), so odd widths never read past a row.  K5b
// rounds every step (__fsub_rn, __fmul_rn, __fadd_rn) so that no multiply
// and add contract into an fma: it computes exactly what the plain
// PyTorch version computes, op by op.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

// the activation codes of K1 (ops/cuda/conv3d.py::ACT_CODES); 3, leaky
// relu 0.1, is not one of K5's
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_ELU = 2, ACT_LEAKY = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// VEC consecutive elements at p as f32: one 16-byte load, or one scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vectors are 16 bytes");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_f32(e[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    from_f32(v[0], p);
  } else {
    uint4 q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int k = 0; k < VEC; ++k) from_f32(v[k], e + k);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

__device__ __forceinline__ int split_end(int S, int split, int rows) {
  const long long end = (long long)(split + 1) * rows;
  return end < S ? (int)end : S;
}

// The block's layout over one batch row's channels: vectors per row (cv),
// vectors per block row (cvb), row lanes (R), and this thread's place.
struct Layout {
  int cv, cvb, R, lane, r0, v;
  __device__ Layout(int C, int vec) {
    cv = C / vec;
    cvb = min(cv, NTHREADS);
    R = NTHREADS / cvb;
    lane = threadIdx.x % cvb;
    r0 = threadIdx.x / cvb;
    v = blockIdx.z * cvb + lane;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
stats_kernel(const T* __restrict__ x, float* __restrict__ part, int S, int C,
             int rows_per_split) {
  extern __shared__ float sh[];  // (2, R, cvb * VEC): sums, then squares
  const Layout l(C, VEC);
  const int b = blockIdx.y, split = blockIdx.x;
  const int s_end = split_end(S, split, rows_per_split);
  float sum[VEC], sq[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sum[k] = sq[k] = 0.f;
  if (l.r0 < l.R && l.v < l.cv) {
    const T* xb = x + (size_t)b * S * C + (size_t)l.v * VEC;
#pragma unroll 4
    for (int s = split * rows_per_split + l.r0; s < s_end; s += l.R) {
      float e[VEC];
      load<T, VEC>(xb + (size_t)s * C, e);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sum[k] += e[k];
        sq[k] = fmaf(e[k], e[k], sq[k]);
      }
    }
  }
  const int W = l.cvb * VEC;
  if (l.r0 < l.R) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh[l.r0 * W + l.lane * VEC + k] = sum[k];
      sh[(l.R + l.r0) * W + l.lane * VEC + k] = sq[k];
    }
  }
  __syncthreads();
  // each output column summed over the row lanes in order
  const int c_base = blockIdx.z * W;
  float* out = part + ((size_t)b * gridDim.x + split) * 2 * C;
  for (int o = threadIdx.x; o < 2 * W; o += NTHREADS) {
    const int which = o / W, col = o % W;
    if (c_base + col >= C) continue;
    float acc = 0.f;
    for (int r = 0; r < l.R; ++r) acc += sh[(which * l.R + r) * W + col];
    out[which * C + c_base + col] = acc;
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if constexpr (ACT == ACT_ELU) {
    // exp(min(y, 0)) - 1 where y <= 0, written so that NaN passes through
    return y > 0.f ? y : __fsub_rn(expf(y), 1.f);
  } else if constexpr (ACT == ACT_RELU) {
    return y < 0.f ? 0.f : y;
  } else if constexpr (ACT == ACT_LEAKY) {
    return y >= 0.f ? y : __fmul_rn(0.01f, y);
  } else {
    return y;
  }
}

template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(NTHREADS)
apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ inv, const float* __restrict__ scale,
             const float* __restrict__ bias, T* __restrict__ out, int S,
             int C, int rows_per_split) {
  const Layout l(C, VEC);
  if (l.r0 >= l.R || l.v >= l.cv) return;
  const int b = blockIdx.y, split = blockIdx.x;
  const int c0 = l.v * VEC;
  float m[VEC], iv[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = mean[(size_t)b * C + c0 + k];
    iv[k] = inv[(size_t)b * C + c0 + k];
    sc[k] = scale[c0 + k];
    bi[k] = bias[c0 + k];
  }
  const size_t base = (size_t)b * S * C + c0;
  const int s_end = split_end(S, split, rows_per_split);
#pragma unroll 4
  for (int s = split * rows_per_split + l.r0; s < s_end; s += l.R) {
    float e[VEC];
    load<T, VEC>(x + base + (size_t)s * C, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float y = __fmul_rn(__fmul_rn(__fsub_rn(e[k], m[k]), iv[k]),
                                sc[k]);
      e[k] = activate<ACT>(__fadd_rn(y, bi[k]));
    }
    store<T, VEC>(out + base + (size_t)s * C, e);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

dim3 grid_of(int splits, int B, int C, int vec) {
  const int cv = C / vec;
  const int cvb = cv < NTHREADS ? cv : NTHREADS;
  return dim3(splits, B, (cv + cvb - 1) / cvb);
}

template <typename T, int VEC>
int stats(const void* x, float* part, int B, int S, int C, int splits,
          int rows_per_split, cudaStream_t st) {
  const int cv = C / VEC;
  const int cvb = cv < NTHREADS ? cv : NTHREADS;
  const size_t smem = 2 * (size_t)(NTHREADS / cvb) * cvb * VEC * sizeof(float);
  stats_kernel<T, VEC><<<grid_of(splits, B, C, VEC), NTHREADS, smem, st>>>(
      static_cast<const T*>(x), part, S, C, rows_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int ACT>
int apply_act(const void* x, const float* mean, const float* inv,
              const float* scale, const float* bias, void* out, int B, int S,
              int C, int splits, int rows_per_split, cudaStream_t st) {
  apply_kernel<T, VEC, ACT><<<grid_of(splits, B, C, VEC), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), mean, inv, scale, bias, static_cast<T*>(out),
      S, C, rows_per_split);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply(const void* x, const float* mean, const float* inv,
          const float* scale, const float* bias, void* out, int B, int S,
          int C, int splits, int rows_per_split, int act, cudaStream_t st) {
  switch (act) {
    case ACT_NONE:
      return apply_act<T, VEC, ACT_NONE>(x, mean, inv, scale, bias, out, B,
                                         S, C, splits, rows_per_split, st);
    case ACT_ELU:
      return apply_act<T, VEC, ACT_ELU>(x, mean, inv, scale, bias, out, B, S,
                                        C, splits, rows_per_split, st);
    case ACT_RELU:
      return apply_act<T, VEC, ACT_RELU>(x, mean, inv, scale, bias, out, B,
                                         S, C, splits, rows_per_split, st);
    case ACT_LEAKY:
      return apply_act<T, VEC, ACT_LEAKY>(x, mean, inv, scale, bias, out, B,
                                          S, C, splits, rows_per_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool check(int B, int S, int C, int splits, int rows_per_split) {
  return B > 0 && B <= 65535 && S > 0 && C > 0 && splits > 0 &&
         rows_per_split > 0 && (long long)splits * rows_per_split >= S &&
         (long long)(splits - 1) * rows_per_split < S;
}

}  // namespace

// x (B, S, C) contiguous, bf16 (bf16 != 0) or f32; part (B, splits, 2, C)
// f32, each split covering rows [split * rows_per_split, + rows_per_split)
// of every batch row.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_group_norm_stats(int bf16, const void* x, float* part,
                                    int B, int S, int C, int splits,
                                    int rows_per_split, void* stream) {
  if (!check(B, S, C, splits, rows_per_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t item = bf16 ? 2 : 4;
  const bool vec = (C * item) % 16 == 0 && aligned16(x);
  if (bf16) {
    return vec ? stats<__nv_bfloat16, 8>(x, part, B, S, C, splits,
                                         rows_per_split, st)
               : stats<__nv_bfloat16, 1>(x, part, B, S, C, splits,
                                         rows_per_split, st);
  }
  return vec ? stats<float, 4>(x, part, B, S, C, splits, rows_per_split, st)
             : stats<float, 1>(x, part, B, S, C, splits, rows_per_split, st);
}

// x, out (B, S, C) contiguous of one dtype, bf16 (bf16 != 0) or f32;
// mean, inv (B, C) and scale, bias (C,) f32; act 0 none, 1 relu, 2 elu,
// 4 leaky relu 0.01.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_group_norm_apply(int bf16, const void* x,
                                    const float* mean, const float* inv,
                                    const float* scale, const float* bias,
                                    void* out, int B, int S, int C,
                                    int splits, int rows_per_split, int act,
                                    void* stream) {
  if (!check(B, S, C, splits, rows_per_split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t item = bf16 ? 2 : 4;
  const bool vec = (C * item) % 16 == 0 && aligned16(x) && aligned16(out);
  if (bf16) {
    return vec ? apply<__nv_bfloat16, 8>(x, mean, inv, scale, bias, out, B,
                                         S, C, splits, rows_per_split, act,
                                         st)
               : apply<__nv_bfloat16, 1>(x, mean, inv, scale, bias, out, B,
                                         S, C, splits, rows_per_split, act,
                                         st);
  }
  return vec ? apply<float, 4>(x, mean, inv, scale, bias, out, B, S, C,
                               splits, rows_per_split, act, st)
             : apply<float, 1>(x, mean, inv, scale, bias, out, B, S, C,
                               splits, rows_per_split, act, st);
}
