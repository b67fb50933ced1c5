// K1: fused GroupNorm-apply + 3x3x3 conv + bias + act + residual + post_act.
//
// Replaces the Pallas TPU kernel gfe_mamba_tpu/ops/pallas/conv3d.py::_kernel
// (launched by _conv3x3x3_fused_p).  It computes, channels-last, SAME
// padding, stride 1:
//
//   out = post_act(act(conv3d(x * a[b,c] + s[b,c], w) + bias) + residual)
//
// where the affine (the folded GroupNorm) applies to real voxels only: the
// zero halo stays zero, as in the JAX kernel, which scales before it pads.
//
// What bounds it on the H100: at the generator's shapes (C = F in
// {64, 128, 256}) a conv does 54*C*F operations per voxel against 2*(C+F)
// bytes of input and output, far above the card's ~295 operations/byte, so
// it is bound by tensor-core work, not memory.  On the way to the tensor
// cores the limit is shared memory: at the bf16 peak an SM's tensor cores
// take ~4,000 FLOP a clock, and the SM reads 128 bytes of shared memory a
// clock, which the TMA writes and the affine pass share.  v6 fed mma.sync
// m16n8k16 by ldmatrix at 32 FLOP per byte read (B re-read by every warp,
// A by every 64-channel tile): the whole bandwidth at the peak.
//
// Two variants, chosen by dtype; neither falls back to the other.
//
// bf16 (conv_mma_kernel): an implicit GEMM on Hopper's warpgroup wgmma
// (m64nNk16, bf16 in, f32 accumulate), with the roles swapped so that
// one wgmma is wide at every level: M = the block's 64 output channels,
// N = an x slice of the output brick (BY columns x 8 z rows), K = 27 * C
// in chunks of 16 input channels.  A block is 2 warpgroups over a BX x
// BY x 8 brick (the launch plan, conv_plan in ops/cuda/conv3d.py, picks
// the brick by shape and the launch checks it against the compiled ones);
// each warpgroup owns BX / 2 slices, 64 channels x 256 voxels, 128 f32
// accumulators a thread.  Per chunk one thread issues three TMA loads
// into a stage of a 2-stage ring, completing on the stage's mbarrier: the
// chunk's 27 x 16 x 64 weights, a box over the (27, C, F) view of w with
// the 128-byte swizzle, and the brick's halo at origin (x0-1, y0-1, z0-1)
// as two planes of 8 channels, 16-byte rows with no swizzle.  The TMA
// writes zeros outside the volume and beyond C and F.  With the GN affine
// all threads form x*a+s in place on the halo's real voxels (bf16 mul.rn
// then add.rn, rounding as the JAX producer pass does); the zero halo
// stays zero.  A (the weights [c][f]) comes to registers by
// ldmatrix.trans, 2 KB per warpgroup and tap.  B (the halo) is read by
// the wgmma itself through a descriptor: 8 z rows of a column are one
// contiguous 128-byte core matrix, the next column lies HZ rows on, the
// second plane PLANE bytes on, and a tap's shift (dx, dy, dz) moves the
// start by whole 16-byte rows, with no im2col buffer.  Per tap a
// warpgroup reads 2 KB (A) + 8 KB (B) for 2 * 64 * 256 * 16 FLOP: 51.2
// FLOP per shared byte at every brick.  With a chunk's TMA writes and
// the affine pass's read and write of the halo the block moves 39.8
// (4 x 16 x 8 brick, the 160 x 160 x 96 and 80 x 80 x 48 levels) and
// 40.2 (8 x 8 x 8, the 40 x 40 x 24 level) FLOP per byte, 44.0 and 44.2
// without the affine (the input gradient); v6 moved 27.3 and 29.1.  The
// output-channel tile stays 64 wide: a chunk of 128 channels' weights
// (108 KB) does not fit twice beside its halo, so a brick's halo is
// fetched once per 64 channels, from L2.  The 27 taps go in 9 groups of
// 3 (one (dx, dy) column), each group's A fragments loaded once the group
// before last is done, so that no register a wgmma in flight reads is
// written (ptxas serialises the wgmmas otherwise); the next chunk's
// affine runs while this chunk's last group does, and once all of its
// wgmmas are done the stage takes chunk k + 2.  The epilogue stages
// the f32 tile [voxel][channel] in the ring's memory, adds bias, applies
// act, adds the residual, applies post_act and rounds once to bf16, 16
// bytes per thread and step.
//
// f32 (conv_fma_kernel): the segmentation UNets' eligible convs, which
// train and predict in f32 as JAX's do (TF32 would lose the 1e-4 parity
// with the CPU), and the generator's f32 checks.  On the H100 it is bound
// by FFMA issue: 54 * C * F operations per voxel at 67 TFLOP/s, against
// 8 * (C + F) bytes; one FFMA per cycle per SM quarter, so every other
// instruction (shared loads, addresses, staging, waits at a barrier)
// takes a slot from the FMAs.  The design keeps those few: an implicit
// GEMM with M = a brick of output voxels, N = TN output channels and
// K = 27 * C in chunks of 8 input channels, each thread holding 8 z rows
// of one (x, y) column x 8 channels (64 accumulators).  For each (dx, dy)
// and channel pair a thread reads its column's 10 shifted halo values
// once (float2) and reuses them for the 3 dz taps, and each tap's 8
// weights come as two float4 (channels 4t.. and TN/2 + 4t..): 44 shared
// loads per 768 FFMAs.  A quarter-warp's 8 lanes read one halo address
// (a broadcast) and 128 contiguous weight bytes, so no read of the inner
// loop conflicts.  The halo is staged [voxel][8 channels] and the weights
// [tap][channel][TN] by 16-byte cp.async into a 2-stage ring, one chunk
// ahead; each thread forms the affine (__fmul_rn then __fadd_rn, as the
// plain version rounds) on the real voxels it copied once its copies
// land, so the zero halo stays zero, and one barrier per chunk publishes
// the stage.  On the H100, 4-channel chunks at two blocks per SM (128
// registers, with spills) or at one, 16 rows per thread, a 3-stage ring,
// and a (dx, dy) or channel-pair loop left rolled were all slower than 8-
// channel chunks in 2 stages at one block per SM (168 registers, no
// spills), whose barrier and staging come half as often, with the (dx,
// dy) loop unrolled by 3 (PERF.md).  The plan
// (conv_f32_plan in ops/cuda/conv3d.py) takes a 64-channel tile over a
// 4 x 8 x 8 brick, or a 32-channel tile over 8 x 8 x 8 where F <= 32 (the
// input gradient of a 32-channel conv), so no FMA lands on a channel
// beyond F.
//
// None of the TPU layout (z-pair lane packing, the 4-slot K layout, VMEM
// staging) is kept.  The TMA, mbarrier, ldmatrix, wgmma, bf16 affine and
// cp.async helpers come from hopper.cuh, shared with K3.

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;            // 8 warps
constexpr int BN = 64;                   // output channels per bf16 block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// activation codes: 0 none, 1 relu, 2 elu, 3 leaky 0.1, 4 leaky 0.01; the
// code is the same for the whole launch, so the switch is taken once per
// vector
template <int N>
__device__ __forceinline__ void apply_act(float (&y)[N], int act) {
  switch (act) {
    case 1:
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = fmaxf(y[j], 0.f);
      break;
    case 2:
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = y[j] > 0.f ? y[j] : expf(y[j]) - 1.f;
      break;
    case 3:
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = y[j] > 0.f ? y[j] : 0.1f * y[j];
      break;
    case 4:
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = y[j] > 0.f ? y[j] : 0.01f * y[j];
      break;
    default:
      break;
  }
}

// 16 bytes as 4 floats or 8 bf16 values widened to floats, and back (bf16
// rounded to nearest even, as __float2bfloat16 does)
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  return make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]),
                    bf16x2_bits(f[4], f[5]), bf16x2_bits(f[6], f[7]));
}

// One block's output: post_act(act(tile + bias) + residual) for the
// brick's real voxels and its TN channels, from the f32 tile[m][n] (row
// stride LD; m = (bx * BY + by) * BZ + bz), 16 bytes of output per thread
// and step.  A thread keeps one 16-byte slot of channels, so it reads its
// bias once; its rows go BATCH at a time, their residual loads issued
// together.  F % 8 == 0, so a vector is all in or all out of range.
template <typename T, int BX, int BY, int BZ, int LD, int TN = BN>
__device__ __forceinline__ void epilogue(
    const float* tile, const T* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, int b, int X, int Y, int Z, int F, int x0, int y0,
    int z0, int n0, int act, int post_act) {
  constexpr int VEC = 16 / sizeof(T), SLOTS = TN / VEC;
  constexpr int STEP = NTHREADS / SLOTS, ROWS = BX * BY * BZ / STEP;
  constexpr int BATCH = 4;
  static_assert(NTHREADS % SLOTS == 0 && ROWS % BATCH == 0, "even split");
  const int n = (threadIdx.x % SLOTS) * VEC, m0 = threadIdx.x / SLOTS;
  const int f = n0 + n;
  if (f >= F) return;
  float bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    bv[j] = bias != nullptr ? to_f(bias[f + j]) : 0.f;
#pragma unroll 1
  for (int i0 = 0; i0 < ROWS; i0 += BATCH) {
    size_t o[BATCH];
    bool in[BATCH];
    uint4 r[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int m = m0 + STEP * (i0 + i), col = m / BZ;
      const int gx = x0 + col / BY, gy = y0 + col % BY, gz = z0 + m % BZ;
      in[i] = gx < X && gy < Y && gz < Z;
      o[i] = ((((size_t)b * X + gx) * Y + gy) * Z + gz) * F + f;
      if (res != nullptr && in[i])
        r[i] = __ldg(reinterpret_cast<const uint4*>(res + o[i]));
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (!in[i]) continue;
      const float* row = tile + (m0 + STEP * (i0 + i)) * LD + n;
      float y[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(row + j);
        y[j] = t.x;
        y[j + 1] = t.y;
        y[j + 2] = t.z;
        y[j + 3] = t.w;
      }
      if (bias != nullptr) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) y[j] += bv[j];
      }
      apply_act(y, act);
      if (res != nullptr) {
        float rv[VEC];
        unpack16(r[i], rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) y[j] += rv[j];
      }
      apply_act(y, post_act);
      *reinterpret_cast<uint4*>(out + o[i]) = pack16(y);
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int CK = 16;                   // input channels per chunk: one k16
constexpr int STAGES = 2;                // the ring
constexpr int NWG = NTHREADS / 128;      // warpgroups
constexpr int W_BYTES = 27 * CK * BN * 2;   // a chunk's weights: 432 rows
constexpr int kb_up(int n) { return (n + 1023) / 1024 * 1024; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The bf16 launch's geometry for a BX x BY x 8 brick.  One wgmma's N is
// an x slice of the brick, BY columns of 8 z rows; each warpgroup owns
// SLICES of the BX slices.  A stage holds the chunk's weights (432 rows
// of 128 bytes, 128-byte swizzle) then its halo as two planes of 16-byte
// rows, channels 0-7 and 8-15 of the chunk (PLANE bytes each, no
// swizzle), from a multiple of 1,024 bytes; the f32 epilogue tile (row
// stride LD, padded so that the accumulators' stores hit distinct banks)
// reuses the ring.
template <int BX_, int BY_>
struct Tile {
  static constexpr int BX = BX_, BY = BY_, BZ = 8;
  static constexpr int BM = BX * BY * BZ;
  static constexpr int N = BY * BZ;              // voxels per wgmma
  static constexpr int SLICES = BX / NWG;        // x slices per warpgroup
  static constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;
  static constexpr int HALO_ROWS = HX * HY * HZ;
  static constexpr int PLANE = (HALO_ROWS * 16 + 127) / 128 * 128;
  static constexpr int STAGE = W_BYTES + kb_up(2 * PLANE);
  static constexpr int LD = BN + 4;
  static constexpr int SMEM = cmax(STAGES * STAGE, BM * LD * 4) + 1024;
  static_assert(BX % NWG == 0, "x slices split over the warpgroups");
  static_assert(N % 8 == 0 && N <= 256, "a wgmma's N");
  static_assert(SLICES * N / 2 <= 128, "accumulators per thread");
  static_assert(SMEM <= 232448, "fits one block's shared memory");
};

// Grid: one block per (brick, 64-channel output tile), the tile fastest,
// so the blocks of one brick run side by side and share its halo in L2;
// bricks in (b, x, y, z) order, z fastest, nxt x nyt x nzt per batch item.
// Thread 0 issues chunks 0 and 1 at the start, then chunk k + 2 once
// every warpgroup's wgmmas of chunk k, whose stage it refills, are done.
template <typename G, bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_mma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __nv_bfloat16* __restrict__ bias,
                const float* __restrict__ a, const float* __restrict__ s,
                const __nv_bfloat16* __restrict__ res,
                __nv_bfloat16* __restrict__ out, int X, int Y, int Z, int C,
                int F, int act, int post_act, int nxt, int nyt, int nzt,
                int ftiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  int id = blockIdx.x;
  const int n0 = (id % ftiles) * BN;
  id /= ftiles;
  const int z0 = (id % nzt) * G::BZ;
  id /= nzt;
  const int y0 = (id % nyt) * G::BY;
  id /= nyt;
  const int x0 = (id % nxt) * G::BX;
  const int b = id / nxt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int nchunks = (C + CK - 1) / CK;

  const unsigned base = (smem_addr(smem) + 1023u) & ~1023u;
  unsigned char* const ring = smem + (base - smem_addr(smem));
  const unsigned full0 = smem_addr(&bars[0]);
  auto load = [&](int k) {
    const unsigned st = base + (k % STAGES) * G::STAGE;
    const unsigned bar = full0 + (k % STAGES) * 8;
    mbar_expect_tx(bar, W_BYTES + 2 * G::HALO_ROWS * 16);
    tma_load_3d(st, &wmap, bar, n0, k * CK, 0);
    tma_load_5d(st + W_BYTES, &xmap, bar, k * CK, z0 - 1, y0 - 1, x0 - 1, b);
    tma_load_5d(st + W_BYTES + G::PLANE, &xmap, bar, k * CK + 8, z0 - 1,
                y0 - 1, x0 - 1, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    mbar_fence_init();
    load(0);
    if (nchunks > 1) load(1);
  }
  __syncthreads();

  // A, the 64 output channels x 16 input channels of a tap (the weights
  // [c][f], .trans): warp wq's rows f = 16 wq .. 16 wq + 15; lane l gives
  // the row c = l % 8 + 8 (l / 16) of 8-channel slot 2 wq + (l / 8) % 2.
  // A tap t adds t * 16 rows of 128 bytes, which keeps the swizzle's phase.
  const unsigned a_lane =
      swz128((lane & 7) + 8 * (lane >> 4), 2 * wq + ((lane >> 3) & 1));
  // B, the chunk's 16 channels of N voxels (an x slice): 8 z rows of a
  // column are one core matrix, the next column (y + 1) HZ rows on, the
  // second plane (channels 8-15) PLANE bytes on; a tap (dx, dy, dz) moves
  // the start by one halo row (16 bytes) per step along z.
  const uint64_t b_desc = wgmma_desc(0, G::PLANE, G::HZ * 16);
  const int b_row0 = wg * G::SLICES * G::HY * G::HZ;

  // halo row r is the voxel (x0 + hx - 1, y0 + hy - 1, z0 + hz - 1); a
  // brick away from the volume's faces has a halo of real voxels only
  const bool inside = x0 >= 1 && y0 >= 1 && z0 >= 1 && x0 + G::BX < X &&
                      y0 + G::BY < Y && z0 + G::BZ < Z;
  auto real = [&](int r) {
    const int hz = r % G::HZ, run = r / G::HZ;
    const int hy = run % G::HY, hx = run / G::HY;
    return (unsigned)(x0 + hx - 1) < (unsigned)X &&
           (unsigned)(y0 + hy - 1) < (unsigned)Y &&
           (unsigned)(z0 + hz - 1) < (unsigned)Z;
  };

  // chunk k's zhat in place: thread t forms the 8 channels of plane t % 2
  // of its halo rows, then publishes its writes to the async proxy, which
  // the wgmmas and the stage's next TMA writes read through
  auto prepare = [&](int k) {
    const int slot = k % STAGES;
    mbar_wait(full0 + 8 * slot, (k / STAGES) & 1);
    if (!AFFINE) return;
    const int c = k * CK + 8 * (threadIdx.x & 1);
    unsigned sc[4], sh[4];
    affine_coeffs(a, s, (size_t)b * C + c, c < C, sc, sh);
    unsigned char* const hp = ring + slot * G::STAGE + W_BYTES;
    const auto at = [](int r, int pl) { return pl * G::PLANE + r * 16; };
    if (inside)
      affine_rows<NTHREADS, 2, G::HALO_ROWS, 8>(hp, sc, sh, at,
                                                [](int) { return true; });
    else
      affine_rows<NTHREADS, 2, G::HALO_ROWS, 8>(hp, sc, sh, at, real);
    fence_proxy_async();
  };

  float acc[G::SLICES][G::N / 2];
#pragma unroll
  for (int i = 0; i < G::SLICES; ++i)
#pragma unroll
    for (int j = 0; j < G::N / 2; ++j) acc[i][j] = 0.f;

  prepare(0);
  __syncthreads();
  for (int k = 0; k < nchunks; ++k) {
    const unsigned st = base + (k % STAGES) * G::STAGE;
    const uint64_t desc = b_desc + ((st + W_BYTES) >> 4) + b_row0;
    // the 27 taps in 9 groups of 3 (one (dx, dy) column, dz = 0, 1, 2):
    // a group's A fragments are loaded before its first wgmma, and once
    // the group before last is done, so that no register a wgmma in
    // flight reads is written and at most two groups hold registers
#pragma unroll
    for (int grp = 0; grp < 9; ++grp) {
      unsigned af[3][4];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        ldsm_x4_trans(st + a_lane + (3 * grp + dz) * CK * 128, af[dz][0],
                      af[dz][1], af[dz][2], af[dz][3]);
      wgmma_fence();
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int shift = ((grp / 3) * G::HY + grp % 3) * G::HZ + dz;
#pragma unroll
        for (int i = 0; i < G::SLICES; ++i)
          wgmma_rs<G::N>(acc[i], af[dz], desc + shift + i * G::HY * G::HZ);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    // the next chunk's zhat while this one's last group runs
    if (k + 1 < nchunks) prepare(k + 1);
    wgmma_wait<0>();
    // every warpgroup is done with this chunk's stage, and the next
    // chunk's zhat is visible; the stage takes chunk k + 2
    __syncthreads();
    if (threadIdx.x == 0 && k + 2 < nchunks) load(k + 2);
  }
#pragma unroll
  for (int i = 0; i < G::SLICES; ++i) wgmma_fence_regs(acc[i]);

  // D[f][n] of slice i, thread (wq, lane) holding acc[i][4j + 2h + e] =
  // D[16 wq + g + 8h][8j + 2q + e], into the f32 tile[voxel][channel]
  // over the ring; the brick's voxel of slice i's column n is
  // (wg * SLICES + i) * N + n
  float* tile = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < G::SLICES; ++i)
#pragma unroll
    for (int j = 0; j < G::N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = (wg * G::SLICES + i) * G::N + 8 * j + 2 * q + e;
          tile[m * G::LD + 16 * wq + g + 8 * h] = acc[i][4 * j + 2 * h + e];
        }
  __syncthreads();
  epilogue<__nv_bfloat16, G::BX, G::BY, G::BZ, G::LD>(
      tile, bias, res, out, b, X, Y, Z, F, x0, y0, z0, n0, act, post_act);
}

template <typename G>
int launch_mma(const void* x, const void* w, const void* bias, const float* a,
               const float* s, const void* res, void* out, int B, int X,
               int Y, int Z, int C, int F, int act, int post_act, int nxt,
               int nyt, int nzt, int ftiles, int smem, cudaStream_t stream) {
  if (nxt != (X + G::BX - 1) / G::BX || nyt != (Y + G::BY - 1) / G::BY ||
      nzt != (Z + G::BZ - 1) / G::BZ || ftiles != (F + BN - 1) / BN ||
      smem != G::SMEM)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * nxt * nyt * nzt * ftiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xmap, wmap;
  // the halo in boxes of 8 channels (16-byte rows), unswizzled
  cudaError_t err = encode_volume(&xmap, x, B, X, Y, Z, C, CK / 2, G::HZ,
                                  G::HY, G::HX, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  // w as (27, C, F): boxes of 64 output channels x 16 input channels x 27
  // taps
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)C, 27};
  const cuuint64_t wstrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)F * 2 * C};
  const cuuint32_t wbox[3] = {BN, CK, 27};
  err = encode_tiled(&wmap, w, 3, wdims, wstrides, wbox,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const bool affine = a != nullptr || s != nullptr;
  const auto kernel =
      affine ? conv_mma_kernel<G, true> : conv_mma_kernel<G, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NTHREADS, G::SMEM, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias), a, s,
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), X, Y, Z, C, F, act, post_act, nxt,
      nyt, nzt, ftiles);
  return (int)cudaGetLastError();
}

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int FCK = 8;       // input channels per chunk: one 32-byte halo row
constexpr int FSTAGES = 2;   // the cp.async ring
constexpr int FBZ = 8;       // z extent of a brick: one thread's rows

// The f32 launch's geometry: TN output channels and a BX x BY x FBZ brick
// per block.  TN / 8 threads share a column's rows and take 8 channels
// each; the other thread index is the (x, y) column.  A stage holds the
// chunk's weights (27 x FCK rows of TN floats) then its halo (HALO rows of
// FCK floats); the f32 epilogue tile (row stride LD) reuses the ring.
template <int TN_, int BX_, int BY_>
struct FTile {
  static constexpr int TN = TN_, BX = BX_, BY = BY_, BZ = FBZ;
  static constexpr int NT = TN / 8;              // threads along N
  static constexpr int BM = BX * BY * BZ;
  static constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;
  static constexpr int HALO = HX * HY * HZ;
  static constexpr int W_FLOATS = 27 * FCK * TN;
  static constexpr int STAGE = W_FLOATS + HALO * FCK;   // floats
  static constexpr int LD = TN + 4;
  static constexpr int SMEM = cmax(FSTAGES * STAGE, BM * LD) * 4;
  static_assert(NTHREADS == NT * BX * BY, "a thread per column and slot");
  static_assert(SMEM <= 232448, "fits one block's shared memory");
};
using FWide = FTile<64, 4, 8>;     // F > 32
using FNarrow = FTile<32, 8, 8>;   // F <= 32

// Grid: one block per (brick, TN-channel output tile), decoded as the bf16
// variant's (tile fastest, then z, y, x and the batch).  Thread t copies
// the 16-byte weight vectors and halo vectors t + 256 j of each chunk,
// then, with the affine, forms x * a + s on those of its halo vectors that
// are real voxels; thread (m, n) = (t / NT, t % NT) accumulates rows
// z0 .. z0 + BZ - 1 of column m (x0 + m / BY, y0 + m % BY) for channels
// n0 + 4n + [0, 4) and n0 + TN/2 + 4n + [0, 4).
template <typename G, bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ a,
                const float* __restrict__ s, const float* __restrict__ res,
                float* __restrict__ out, int X, int Y, int Z, int C, int F,
                int act, int post_act, int nxt, int nyt, int nzt,
                int ftiles) {
  constexpr int CK = FCK, HV = CK / 4;   // 16-byte vectors per halo row
  extern __shared__ __align__(128) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  int id = blockIdx.x;
  const int n0 = (id % ftiles) * G::TN;
  id /= ftiles;
  const int z0 = (id % nzt) * G::BZ;
  id /= nzt;
  const int y0 = (id % nyt) * G::BY;
  id /= nyt;
  const int x0 = (id % nxt) * G::BX;
  const int b = id / nxt;
  const int nchunks = (C + CK - 1) / CK;

  // halo row p is the voxel (x0 + hx - 1, y0 + hy - 1, z0 + hz - 1)
  auto voxel = [&](int p, size_t& off) {
    const int hz = p % G::HZ, q = p / G::HZ;
    const int hy = q % G::HY, hx = q / G::HY;
    const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
    off = (((size_t)b * X + gx) * Y + gy) * Z + gz;
    return (unsigned)gx < (unsigned)X && (unsigned)gy < (unsigned)Y &&
           (unsigned)gz < (unsigned)Z;
  };
  // chunk k's weights w[t][c0 + kk][n0 + n] (zeros beyond C and F) and
  // halo x[voxel][c0 .. c0 + CK) (zeros outside the volume and beyond C)
  // into its stage
  auto load = [&](int k) {
    float* const st = ring + (k % FSTAGES) * G::STAGE;
    const int c0 = k * CK;
    constexpr int WV = G::TN / 4;
    for (int i = threadIdx.x; i < 27 * CK * WV; i += NTHREADS) {
      const int v = i % WV, r = i / WV;   // r = tap * CK + kk
      const int c = c0 + r % CK, f = n0 + 4 * v;
      const bool in = c < C && f < F;
      const float* src = in ? w + ((size_t)(r / CK) * C + c) * F + f : w;
      cp_async16(smem_addr(st + r * G::TN + 4 * v), src, in);
    }
    float* const hs = st + G::W_FLOATS;
    for (int i = threadIdx.x; i < G::HALO * HV; i += NTHREADS) {
      const int p = i / HV, c = c0 + 4 * (i % HV);
      size_t off;
      const bool in = voxel(p, off) && c < C;
      cp_async16(smem_addr(hs + 4 * i), in ? x + off * C + c : x, in);
    }
  };
  // x * a + s on the real halo vectors this thread copied for chunk k
  // (all of one 4-channel group: NTHREADS % HV == 0), each step rounded
  // as the plain version's
  auto affine = [&](int k) {
    float* const hs = ring + (k % FSTAGES) * G::STAGE + G::W_FLOATS;
    const int c = k * CK + 4 * (threadIdx.x % HV);
    if (c >= C) return;
    const size_t ac = (size_t)b * C + c;
    float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a != nullptr) sc = __ldg(reinterpret_cast<const float4*>(a + ac));
    if (s != nullptr) sh = __ldg(reinterpret_cast<const float4*>(s + ac));
    for (int i = threadIdx.x; i < G::HALO * HV; i += NTHREADS) {
      size_t off;
      if (!voxel(i / HV, off)) continue;
      float4 v = *reinterpret_cast<float4*>(hs + 4 * i);
      if (a != nullptr) {
        v.x = __fmul_rn(v.x, sc.x);
        v.y = __fmul_rn(v.y, sc.y);
        v.z = __fmul_rn(v.z, sc.z);
        v.w = __fmul_rn(v.w, sc.w);
      }
      if (s != nullptr) {
        v.x = __fadd_rn(v.x, sh.x);
        v.y = __fadd_rn(v.y, sh.y);
        v.z = __fadd_rn(v.z, sh.z);
        v.w = __fadd_rn(v.w, sh.w);
      }
      *reinterpret_cast<float4*>(hs + 4 * i) = v;
    }
  };

  const int tn = threadIdx.x % G::NT, mt = threadIdx.x / G::NT;
  const int bx = mt / G::BY, by = mt % G::BY;
  float acc[G::BZ][8];
#pragma unroll
  for (int i = 0; i < G::BZ; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int k = 0; k < FSTAGES - 1; ++k) {
    if (k < nchunks) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<FSTAGES - 2>();   // this thread's copies of chunk k
    if (AFFINE) affine(k);
    // chunk k is whole for every thread, and every thread is done with
    // chunk k - 1, whose stage the load below refills
    __syncthreads();
    if (k + FSTAGES - 1 < nchunks) load(k + FSTAGES - 1);
    cp_async_commit();
    const float* const st = ring + (k % FSTAGES) * G::STAGE;
    const float* const hs = st + G::W_FLOATS + (bx * G::HY + by) * G::HZ * CK;
    const float* const ws = st + 4 * tn;
#pragma unroll 3
    for (int dxy = 0; dxy < 9; ++dxy) {
      const int dx = dxy / 3, dy = dxy % 3;
      const float* const hp = hs + (dx * G::HY + dy) * G::HZ * CK;
      const float* const wp = ws + dxy * 3 * CK * G::TN;
#pragma unroll
      for (int kp = 0; kp < CK / 2; ++kp) {
        float2 av[G::BZ + 2];   // rows z0 - 1 .. z0 + BZ of two channels
#pragma unroll
        for (int z = 0; z < G::BZ + 2; ++z)
          av[z] = *reinterpret_cast<const float2*>(hp + z * CK + 2 * kp);
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float* const wr = wp + (dz * CK + 2 * kp + kk) * G::TN;
            const float4 b0 = *reinterpret_cast<const float4*>(wr);
            const float4 b1 =
                *reinterpret_cast<const float4*>(wr + G::TN / 2);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < G::BZ; ++i) {
              const float ai = kk ? av[i + dz].y : av[i + dz].x;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the tile overwrites the ring

  float* const tile = ring;
#pragma unroll
  for (int i = 0; i < G::BZ; ++i) {
    float* const row = tile + (mt * G::BZ + i) * G::LD + 4 * tn;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + G::TN / 2) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  epilogue<float, G::BX, G::BY, G::BZ, G::LD, G::TN>(
      tile, bias, res, out, b, X, Y, Z, F, x0, y0, z0, n0, act, post_act);
}

template <typename G>
int launch_fma(const float* x, const float* w, const float* bias,
               const float* a, const float* s, const float* res, float* out,
               int B, int X, int Y, int Z, int C, int F, int act,
               int post_act, int nxt, int nyt, int nzt, int ftiles,
               int smem, cudaStream_t stream) {
  if (nxt != (X + G::BX - 1) / G::BX || nyt != (Y + G::BY - 1) / G::BY ||
      nzt != (Z + G::BZ - 1) / G::BZ || ftiles != (F + G::TN - 1) / G::TN ||
      smem != G::SMEM)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * nxt * nyt * nzt * ftiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool affine = a != nullptr || s != nullptr;
  const auto kernel =
      affine ? conv_fma_kernel<G, true> : conv_fma_kernel<G, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NTHREADS, G::SMEM, stream>>>(
      x, w, bias, a, s, res, out, X, Y, Z, C, F, act, post_act, nxt, nyt,
      nzt, ftiles);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 variant.  x (B,X,Y,Z,C), w (3,3,3,C,F), bias (F,), residual and out
// (B,X,Y,Z,F) bf16, contiguous and 16-byte aligned; a, s (B,C) float32
// holding bf16 values; bias, a, s and res may be null.  C and F are
// multiples of 8.  The launch plan: the brick (bx, by, bz), which must be
// a compiled one; the volume's nxt x nyt x nzt bricks per batch item and
// ftiles tiles of 64 output channels; the ring's stages and the dynamic
// shared memory, which must be what the brick needs.  Returns a
// cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_bf16(const void* x, const void* w,
                                  const void* bias, const float* a,
                                  const float* s, const void* res, void* out,
                                  int B, int X, int Y, int Z, int C, int F,
                                  int act, int post_act, int bx, int by,
                                  int bz, int nxt, int nyt, int nzt,
                                  int ftiles, int stages, int smem,
                                  void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || F <= 0 ||
      stages != STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bz != 8) return (int)cudaErrorInvalidValue;
  if (bx == 8 && by == 8)
    return launch_mma<Tile<8, 8>>(x, w, bias, a, s, res, out, B, X, Y, Z, C,
                                  F, act, post_act, nxt, nyt, nzt, ftiles,
                                  smem, st);
  if (bx == 4 && by == 16)
    return launch_mma<Tile<4, 16>>(x, w, bias, a, s, res, out, B, X, Y, Z,
                                   C, F, act, post_act, nxt, nyt, nzt,
                                   ftiles, smem, st);
  return (int)cudaErrorInvalidValue;
}

// f32 variant: the same tensors in float32, a and s (B,C) float32.  The
// launch plan (conv_f32_plan): the brick (bx, by, bz) and output-channel
// tile tn, which must be a compiled pair; the volume's nxt x nyt x nzt
// bricks per batch item and ftiles tiles of tn channels; the ring's stages
// and the dynamic shared memory, which must be what the tile needs.
// Returns a cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_f32(const float* x, const float* w,
                                 const float* bias, const float* a,
                                 const float* s, const float* res,
                                 float* out, int B, int X, int Y, int Z,
                                 int C, int F, int act, int post_act, int bx,
                                 int by, int bz, int tn, int nxt, int nyt,
                                 int nzt, int ftiles, int stages, int smem,
                                 void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || F <= 0 ||
      C % 8 || F % 8 || bz != FBZ || stages != FSTAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tn == FWide::TN && bx == FWide::BX && by == FWide::BY)
    return launch_fma<FWide>(x, w, bias, a, s, res, out, B, X, Y, Z, C, F,
                             act, post_act, nxt, nyt, nzt, ftiles, smem, st);
  if (tn == FNarrow::TN && bx == FNarrow::BX && by == FNarrow::BY)
    return launch_fma<FNarrow>(x, w, bias, a, s, res, out, B, X, Y, Z, C, F,
                               act, post_act, nxt, nyt, nzt, ftiles, smem,
                               st);
  return (int)cudaErrorInvalidValue;
}
