// Hopper building blocks shared by K1 (conv3d.cu) and K3 (conv3d_dw.cu):
// TMA tensor maps and box loads completing on mbarriers, ldmatrix and
// mma.sync m16n8k16 on bf16 (K3), warpgroup wgmma.mma_async with A from
// registers and B by shared-memory descriptor (K1), the in-place bf16
// affine pass that forms zhat = x * a + s on staged rows, and the 16-byte
// cp.async copies that stage the f32 variants' operands.
//
// A staged row is a run of channels of one voxel, cut in 16-byte slots.
// With 128-byte rows the TMA's 128-byte swizzle XORs the slot index with
// the row mod 8 (swz128), so that ldmatrix reads 8 rows without bank
// conflicts; the pattern follows the shared-memory address, so a swizzled
// buffer starts on a multiple of 1,024 bytes.  Rows of 16 bytes (one
// slot) are staged without a swizzle: 8 consecutive rows are one
// contiguous 128-byte core matrix of wgmma's unswizzled layout.

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

// ---- wgmma (sm_90a) ----
//
// A warpgroup (4 consecutive warps, the first a multiple of 4) issues
// wgmma.mma_async together; it runs asynchronously.  wgmma_fence orders
// this thread's earlier register writes (the A fragment) before the next
// wgmma reads them; wgmma_commit closes the group of wgmmas issued since
// the last one; wgmma_wait<N> waits until at most N groups are in flight,
// after which their accumulators and the shared memory they read are
// free.  Shared memory written by ordinary stores must be published to
// wgmma (the async proxy) with fence_proxy_async and a barrier.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of accumulators across a
// wgmma_wait: an empty asm that claims to read and write each register.
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory descriptor of a K-major operand in the unswizzled
// layout: core matrices of 8 rows x 16 bytes (8 bf16 of K), each 128
// contiguous bytes from `addr`; `lbo` bytes from one core matrix to the
// next along K, `sbo` bytes from one group of 8 rows to the next along M
// or N.  All three are multiples of 16 and below 256 KB.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d += a * b over m64nNk16, bf16 in, f32 accumulate.  a, the 64 x 16 A
// tile, comes from registers: warp w of the warpgroup holds rows 16w ..
// 16w + 15 in mma.sync m16n8k16's A layout (a[0] row g, columns 2q, 2q+1;
// a[1] row g + 8; a[2], a[3] the same 8 columns on; g = lane / 4, q =
// lane % 4).  b, the 16 x N B tile, is K-major by descriptor.  Thread
// (warp w, lane) receives d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e].
// Defined for the N that K1's bricks take: 64 and 128.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4],
                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                               const unsigned (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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
