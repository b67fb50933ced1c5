// K3: the weight gradient of the 3x3x3 conv of K1.
//
// Replaces the Pallas TPU kernel gfe_mamba_tpu/ops/pallas/conv3d.py::_dw_kernel
// (launched by _dw_pallas_p from the conv's backward _bwd_p).  It computes,
// channels-last, in f32:
//
//   dw[i,j,k,c,f] = sum_{b,x,y,z} zhat[b,x+i-1,y+j-1,z+k-1,c] * g1[b,x,y,z,f]
//
// with zhat = x * a[b,c] + s[b,c] (the folded GroupNorm, rounded to x's
// dtype after the scale and after the shift, as JAX does) on real voxels
// and 0 outside the volume, and g1 the cotangent after the activation
// gradients.
//
// What bounds it on the H100: 2 * V * 27 * C * F operations for V voxels
// against one read of x and g1 (2 * V * (C + F) bytes in bf16); at the
// generator's shapes that is ~430 operations per byte, so it is bound by
// arithmetic, not memory.
//
// Design: for each tap the gradient is a GEMM dw_t = zhat_t^T g1 with
// M = C, N = F and K = the voxels, where zhat_t is zhat shifted by the
// tap.  A block owns one tap and a 64 x 64 tile of (c, f), and a range of
// voxels (split-K): per chunk of 32 consecutive voxels it stages the
// shifted zhat rows (the affine applied as they load, the halo zero) and
// the g1 rows in shared memory as f32, then each of 256 threads
// accumulates a 4 x 4 tile on the CUDA cores.  Every block writes its f32
// partial to (splits, 27, C, F); the caller sums over splits, a second
// pass in a fixed order, so the result is deterministic.  bf16 inputs are
// widened to f32 as they are staged.  This is the simple, correct first
// version: tensor cores (mma.sync on bf16), a block that serves several
// taps from one staged halo, and overlapped staging are later work.  No
// TPU layout (z-pair packing, parity blocks) is kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // c and f per block
constexpr int KC = 32;        // voxels per shared-memory chunk
constexpr int NTHREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
          const float* __restrict__ a, const float* __restrict__ s,
          float* __restrict__ part, int X, int Y, int Z, int C, int F,
          int voxels, int chunk, int ctiles, int ftiles) {
  constexpr int VEC = Vec<T>::N;
  __shared__ __align__(16) float As[KC][TILE];  // zhat_t[v][c]
  __shared__ __align__(16) float Bs[KC][TILE];  // g1[v][f]

  int tile = blockIdx.y;
  const int ft = tile % ftiles;
  tile /= ftiles;
  const int ct = tile % ctiles;
  const int tap = tile / ctiles;
  const int di = tap / 9 - 1, dj = (tap / 3) % 3 - 1, dk = tap % 3 - 1;
  const int c0 = ct * TILE, f0 = ft * TILE;
  const int v_begin = blockIdx.x * chunk;
  const int v_end = min(voxels, v_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int v0 = v_begin; v0 < v_end; v0 += KC) {
    // shifted zhat rows, VEC channels per 16-byte load (C % 8 == 0, so a
    // vector is all in or all out of range)
    for (int i = threadIdx.x; i < KC * (TILE / VEC); i += NTHREADS) {
      const int r = i / (TILE / VEC), cv = (i % (TILE / VEC)) * VEC;
      const int v = v0 + r, c = c0 + cv;
      float vals[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
      if (v < v_end && c < C) {
        const int z = v % Z;
        int rest = v / Z;
        const int y = rest % Y;
        rest /= Y;
        const int xx = rest % X, b = rest / X;
        const int sx = xx + di, sy = y + dj, sz = z + dk;
        if (sx >= 0 && sx < X && sy >= 0 && sy < Y && sz >= 0 && sz < Z) {
          const size_t off = ((((size_t)b * X + sx) * Y + sy) * Z + sz) * C + c;
          alignas(16) T raw[VEC];
          *reinterpret_cast<uint4*>(raw) =
              __ldg(reinterpret_cast<const uint4*>(x + off));
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float t = to_f(raw[j]);
            if (a != nullptr) t = to_f(from_f<T>(t * a[(size_t)b * C + c + j]));
            if (s != nullptr) t = to_f(from_f<T>(t + s[(size_t)b * C + c + j]));
            vals[j] = t;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(&As[r][cv + j]) =
            make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
    // g1 rows (unshifted)
    for (int i = threadIdx.x; i < KC * (TILE / VEC); i += NTHREADS) {
      const int r = i / (TILE / VEC), fv = (i % (TILE / VEC)) * VEC;
      const int v = v0 + r, f = f0 + fv;
      float vals[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
      if (v < v_end && f < F) {
        alignas(16) T raw[VEC];
        *reinterpret_cast<uint4*>(raw) = __ldg(
            reinterpret_cast<const uint4*>(g + (size_t)v * F + f));
#pragma unroll
        for (int j = 0; j < VEC; ++j) vals[j] = to_f(raw[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(&Bs[r][fv + j]) =
            make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // partial[split][tap][c][f]; F % 8 == 0 keeps each float4 in or out
  const int f = f0 + tx * 4;
  if (f >= F) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
    float* row = part + (((size_t)blockIdx.x * 27 + tap) * C + c) * F + f;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
int launch(const void* x, const void* g, const float* a, const float* s,
           float* part, int B, int X, int Y, int Z, int C, int F, int splits,
           cudaStream_t stream) {
  const long long voxels = (long long)B * X * Y * Z;
  if (voxels <= 0 || voxels > 0x7fffffffLL || splits <= 0)
    return (int)cudaErrorInvalidValue;
  long long chunk = (voxels + splits - 1) / splits;
  chunk = (chunk + KC - 1) / KC * KC;
  const int ctiles = (C + TILE - 1) / TILE, ftiles = (F + TILE - 1) / TILE;
  const long long tiles = 27LL * ctiles * ftiles;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)splits, (unsigned)tiles);
  dw_kernel<T><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), a, s, part, X, Y,
      Z, C, F, (int)voxels, (int)chunk, ctiles, ftiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x (B,X,Y,Z,C) and g (B,X,Y,Z,F) in that
// dtype, contiguous and 16-byte aligned; a, s (B,C) float32 or null; part
// (splits,27,C,F) float32, every element written.  C and F are multiples
// of 8.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_dw(int dtype, const void* x, const void* g,
                                const float* a, const float* s, float* part,
                                int B, int X, int Y, int Z, int C, int F,
                                int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, a, s, part, B, X, Y, Z, C, F, splits,
                                 st);
  if (dtype == 0)
    return launch<float>(x, g, a, s, part, B, X, Y, Z, C, F, splits, st);
  return (int)cudaErrorInvalidValue;
}
