// Hopper building blocks shared by K1 (conv3d.cu) and K3 (conv3d_dw.cu):
// TMA tensor maps and box loads completing on mbarriers, ldmatrix and
// mma.sync m16n8k16 on bf16, the in-place bf16 affine pass that forms
// zhat = x * a + s on staged rows, and the 16-byte cp.async copies that
// stage the f32 variants' operands.
//
// A staged row is a run of channels of one voxel, cut in 16-byte slots.
// The TMA's swizzles move the slots inside each row so that ldmatrix reads
// 8 rows without bank conflicts: with 128-byte rows the slot index is
// XORed with the row mod 8 (swz128); with 32-byte rows the two slots swap
// every 4 rows (swz32).  Both patterns follow the shared-memory address,
// so a staged buffer starts on a multiple of 1,024 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte slot `slot` of row `r` under the TMA's 128-byte
// swizzle (128-byte rows)
__device__ __forceinline__ unsigned swz128(int r, int slot) {
  return (unsigned)(r * 128 + ((slot ^ (r & 7)) << 4));
}

// the same under the 32-byte swizzle (32-byte rows)
__device__ __forceinline__ unsigned swz32(int r, int slot) {
  return (unsigned)(r * 32 + (((slot ^ (r >> 2)) & 1) << 4));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// make the barriers' initialisation visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity`.  A phase that never completes (a fault
// in a descriptor) ends the kernel with an error instead of a hang.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (int spin = 0; !mbar_try_wait(bar, parity);)
    if (++spin == (1 << 22)) __trap();
}

// one arrival that also expects `bytes` of TMA writes before the phase
// completes
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// TMA (async-proxy) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA load of a (c, z, y, x, b) box at the given (signed) origin;
// what lies outside the tensor lands as zeros.
__device__ __forceinline__ void tma_load_5d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c, int z, int y,
                                            int x, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(z), "r"(y), "r"(x),
      "r"(b), "r"(bar)
      : "memory");
}

// One TMA load of a 3-D box, innermost coordinate first.
__device__ __forceinline__ void tma_load_3d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int i0, int i1,
                                            int i2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(i0), "r"(i1), "r"(i2),
      "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1;
// without `full` the 16 bytes land as zeros and nothing is read
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// close this thread's group of cp.async copies issued since the last one
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight; the
// bytes of the others are then visible to this thread
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a * b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// two bf16 values of (a or s), lower address in the low half; `none`
// without p
__device__ __forceinline__ unsigned bf16_pair(const float* p, size_t i,
                                              float none) {
  const float lo = p != nullptr ? __ldg(p + i) : none;
  const float hi = p != nullptr ? __ldg(p + i + 1) : none;
  return bf16x2_bits(lo, hi);
}

// round(round(x * a) + s) on a bf16 pair: mul.rn and add.rn round the
// exact product and the exact sum once each, as the plain version's f32
// arithmetic rounded to bf16 does
__device__ __forceinline__ unsigned affine_pair(unsigned v, unsigned sc,
                                                unsigned sh) {
  asm("mul.rn.bf16x2 %0, %0, %1;\n" : "+r"(v) : "r"(sc));
  asm("add.rn.bf16x2 %0, %0, %1;\n" : "+r"(v) : "r"(sh));
  return v;
}

// The scale and shift of 8 channels [i, i + 8) of the flat (B, C) arrays
// a and s as bf16 pairs.  Without a channel inside the volume (`in`
// false) or without a or s, the pass multiplies by 1 and adds -0, which
// keeps every value, zeros included.
__device__ __forceinline__ void affine_coeffs(const float* a, const float* s,
                                              size_t i, bool in,
                                              unsigned (&sc)[4],
                                              unsigned (&sh)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = bf16_pair(in ? a : nullptr, i + 2 * j, 1.f);
    sh[j] = bf16_pair(in ? s : nullptr, i + 2 * j, -0.f);
  }
}

// zhat in place on ROWS staged rows of SLOTS 16-byte slots.  Thread t
// takes slot t % SLOTS of rows t / SLOTS + (NT / SLOTS) j, with that
// slot's 8 channels' coefficients (affine_coeffs), its loads batched
// BATCH at a time (a loop with a branch per row costs ~40% more on the
// H100).  at(r, slot) is the slot's byte offset under the staging's
// swizzle; rows for which real(r) is false (the halo outside the volume)
// keep the TMA's zeros.
template <int NT, int SLOTS, int ROWS, int BATCH, typename At, typename Real>
__device__ __forceinline__ void affine_rows(unsigned char* buf,
                                            const unsigned (&sc)[4],
                                            const unsigned (&sh)[4], At at,
                                            Real real) {
  constexpr int STEP = NT / SLOTS;
  constexpr int PER = (ROWS + STEP - 1) / STEP;   // rows per thread, at most
  const int slot = threadIdx.x % SLOTS, r0 = threadIdx.x / SLOTS;
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += BATCH) {
    uint4 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + STEP * (j0 + j);
      if (j0 + j < PER && r < ROWS)
        v[j] = *reinterpret_cast<const uint4*>(buf + at(r, slot));
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int r = r0 + STEP * (j0 + j);
      if (j0 + j >= PER || r >= ROWS || !real(r)) continue;
      v[j].x = affine_pair(v[j].x, sc[0], sh[0]);
      v[j].y = affine_pair(v[j].y, sc[1], sh[1]);
      v[j].z = affine_pair(v[j].z, sc[2], sh[2]);
      v[j].w = affine_pair(v[j].w, sc[3], sh[3]);
      *reinterpret_cast<uint4*>(buf + at(r, slot)) = v[j];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The TMA descriptor of a bf16 tensor of `rank` dimensions, innermost
// first: extents `dims`, byte strides of dimensions 1.. `strides`
// (multiples of 16), read in boxes of `box`, zero outside the tensor.
// cuTensorMapEncodeTiled comes from the driver through the runtime, so a
// library links nothing beyond cudart.
inline cudaError_t encode_tiled(CUtensorMap* map, const void* base, int rank,
                                const cuuint64_t* dims,
                                const cuuint64_t* strides,
                                const cuuint32_t* box,
                                CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A channels-last bf16 volume (B, X, Y, Z, ch) read in (box_ch, bz, by,
// bx, 1) boxes.
inline cudaError_t encode_volume(CUtensorMap* map, const void* base, int B,
                                 int X, int Y, int Z, int ch, int box_ch,
                                 int bz, int by, int bx,
                                 CUtensorMapSwizzle swizzle) {
  const cuuint64_t row = (cuuint64_t)ch * 2;
  const cuuint64_t dims[5] = {(cuuint64_t)ch, (cuuint64_t)Z, (cuuint64_t)Y,
                              (cuuint64_t)X, (cuuint64_t)B};
  const cuuint64_t strides[4] = {row, row * Z, row * Z * Y, row * Z * Y * X};
  const cuuint32_t box[5] = {(cuuint32_t)box_ch, (cuuint32_t)bz,
                             (cuuint32_t)by, (cuuint32_t)bx, 1};
  return encode_tiled(map, base, 5, dims, strides, box, swizzle);
}

}  // namespace
