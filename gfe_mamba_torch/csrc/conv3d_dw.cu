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
// tensor-core arithmetic, not memory.
//
// Two variants, chosen by dtype; neither falls back to the other.
//
// bf16 (dw_mma_kernel): per tap the gradient is a GEMM dw_t = zhat_t^T g1
// with M = C, N = F and K = the voxels.  A block owns a 64 x 64 (c, f)
// tile, the 9 taps of one dx, and a run of 4 x 4 x 16 voxel bricks
// (split-K).  Per brick it stages, in bf16 and channels-last, the raw x
// slab those 9 taps read (the 4 x-slices x0+dx-1.., 6 y, 18 z: 432 rows)
// and the brick's 256 g1 rows: two TMA loads issued by one thread, zero
// outside the volume and beyond C or F, with the 128-byte swizzle (each
// row's 16-byte slots XORed with the row mod 8, so ldmatrix reads 8 rows
// without bank conflicts).  A bare copy cannot form zhat, whose halo must
// stay 0, so with the affine all threads then apply it in place to the
// slab's real voxels (mul.rn then add.rn on bf16 pairs: each step rounds
// once, as the plain version's f32 arithmetic rounded to bf16 does).  The
// stages are double-buffered: the next brick's loads are issued after
// that pass and land while the current brick's MMAs run.  For each
// 16-voxel z run a warp loads its g1 fragments (B, ldmatrix.trans) once
// and reuses them for all 9 taps; each tap's zhat fragment (A,
// ldmatrix.trans) is the same run shifted by (dy, dz) in the slab, so one
// staged slab serves 9 taps.  Products are mma.sync m16n8k16 (bf16 in,
// f32 accumulate); each warp holds a 16 (c) x 32 (f) tile of all 9 taps,
// 144 f32 accumulators.  bf16 products are exact in f32, so only the order
// of the f32 sums differs from the plain version.  On the H100 the affine
// pass takes about a quarter of the 64-channel time (chip_smoke.py times
// the kernel with and without it); forming zhat in registers per tap, or
// in a producer warpgroup, measured slower.

// f32 (dw_fma_kernel): the segmentation UNets' weight gradients, which
// JAX takes in f32 (TF32 would lose the 1e-4 parity with the CPU).  On the
// H100 it is bound by FFMA issue (2 * V * 27 * C * F operations at 67
// TFLOP/s against 4 * V * (C + F) bytes), so the design spends as few
// instructions as it can on anything but FMAs.  It has dw_mma_kernel's
// structure with FFMA in place of mma.sync: a block owns a 64 x 64 (c, f)
// tile, the 9 taps of one dx and a run of 1 x 8 x 16 voxel bricks
// (split-K).  Per brick it stages the raw x slab those 9 taps read (1 x 10
// x 18 rows of 64 channels) and the brick's 128 g1 rows by 16-byte
// cp.async, double-buffered, and forms zhat once per staged element (each
// thread on the real rows it copied: __fmul_rn then __fadd_rn).  Each
// thread keeps a 4 (c) x 4 (f) tile of all 9 taps in registers (144
// accumulators) and walks each z run with a window of 3 slab rows per dy,
// so a voxel costs one g1 and three slab float4 loads for 144 FFMAs.  The
// plan (dw_fma_plan in ops/cuda/conv3d.py) splits the bricks so that the
// blocks fill whole waves of one block per SM as nearly as it can.
//
// Both write one f32 partial per (split, tap, c, f), every element once;
// the caller sums the splits in a fixed order, so dw is deterministic (no
// atomics).  No TPU layout (z-pair packing, parity blocks) is kept.  The
// TMA, mbarrier, ldmatrix / mma.sync, bf16 affine and cp.async helpers
// come from hopper.cuh, shared with K1.

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;        // c and f per block
constexpr int NTHREADS = 256;   // 8 warps

// ---- bf16: tensor cores -------------------------------------------------

constexpr int BX = 4, BY = 4, BZ = 16;         // voxel brick
constexpr int BV = BX * BY * BZ;               // 256 voxels, 16 z runs
constexpr int SY = BY + 2, SZ = BZ + 2;        // slab of one dx: BX x SY x SZ
constexpr int SLAB_ROWS = BX * SY * SZ;        // 432
constexpr int ROW_BYTES = TILE * 2;            // 64 bf16 channels
constexpr int STAGE_BYTES = (SLAB_ROWS + BV) * ROW_BYTES;   // 88,064
// two stages, and room to align the first to the 1,024 bytes over which
// the TMA's 128-byte swizzle repeats (both stage parts are multiples of it)
constexpr int MMA_SMEM = 2 * STAGE_BYTES + 1024;
static_assert(SLAB_ROWS * ROW_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "stage parts keep the swizzle's 1,024-byte alignment");
constexpr int GROUP_TAPS = 9;                  // one dx, every (dy, dz)
constexpr int N8 = 4;                          // n8 tiles per warp (32 f)

struct Brick {
  int b, x0, y0, z0;
};

// brick i of the volume, z fastest: (b, xt, yt, zt) of a (B, nxt, nyt,
// nzt) grid of BX_ x BY_ x BZ_ bricks
template <int BX_ = BX, int BY_ = BY, int BZ_ = BZ>
__device__ __forceinline__ Brick brick_at(int i, int nxt, int nyt, int nzt) {
  Brick r;
  r.z0 = (i % nzt) * BZ_;
  i /= nzt;
  r.y0 = (i % nyt) * BY_;
  i /= nyt;
  r.x0 = (i % nxt) * BX_;
  r.b = i / nxt;
  return r;
}

// Brick k's raw x slab (for the block's dx) and g1 rows into the stage at
// `st`; the barrier completes when all STAGE_BYTES have landed.
__device__ __forceinline__ void stage_brick(unsigned st, unsigned bar,
                                            const CUtensorMap* xmap,
                                            const CUtensorMap* gmap,
                                            const Brick& k, int dx, int c0,
                                            int f0) {
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load_5d(st, xmap, bar, c0, k.z0 - 1, k.y0 - 1, k.x0 + dx - 1, k.b);
  tma_load_5d(st + SLAB_ROWS * ROW_BYTES, gmap, bar, f0, k.z0, k.y0, k.x0,
              k.b);
}

// zhat in place on the real voxels of brick k's staged raw slab
// (affine_rows: thread t takes the 16-byte slot t % 8, 8 channels, of
// rows t / 8 + 32 j).  A row is real when its (x, y) run and its z are
// inside the volume; beyond C the slot holds zeros and dw there is never
// written.
__device__ void affine_slab(unsigned char* slab, const float* __restrict__ a,
                            const float* __restrict__ s, const Brick& k,
                            int dx, int X, int Y, int Z, int C, int c0) {
  const int c = c0 + 8 * (threadIdx.x & 7);
  unsigned sc[4], sh[4];
  affine_coeffs(a, s, (size_t)k.b * C + c, c < C, sc, sh);
  // real (x, y) runs as a bit mask over run = sx * SY + hy; real z rows
  unsigned runs = 0;
#pragma unroll
  for (int sx = 0; sx < BX; ++sx) {
    const int gx = k.x0 + sx + dx - 1;
    if (gx < 0 || gx >= X) continue;
#pragma unroll
    for (int hy = 0; hy < SY; ++hy) {
      const int gy = k.y0 + hy - 1;
      runs |= (unsigned)(gy >= 0 && gy < Y) << (sx * SY + hy);
    }
  }
  const int hz_lo = max(0, 1 - k.z0), hz_hi = min(SZ, Z + 1 - k.z0);
  affine_rows<NTHREADS, 8, SLAB_ROWS, 7>(
      slab, sc, sh, [](int r, int slot) { return swz128(r, slot); },
      [&](int r) {
        const int run = r / SZ, hz = r - run * SZ;
        return ((runs >> run) & 1u) && hz >= hz_lo && hz < hz_hi;
      });
}

// Grid: x = (group, f tile, c tile), group fastest, so the dx groups of
// one split run side by side and share the brick in L2; group g serves
// the 9 taps of dx = (dxs >> 2g) & 3 (the caller's table).  y = the
// split.  Split s takes bricks [s * per, min(nbricks, (s + 1) * per)).
// Thread 0 issues each brick's TMA loads one brick ahead, into the stage
// the previous brick freed; the stage's mbarrier completes when its bytes
// have landed.  With the affine, all 8 warps form zhat in place before the
// MMAs, and the next brick's loads are issued after that pass (issued
// before it, they slowed it).
template <bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 1)
dw_mma_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap gmap,
              const float* __restrict__ a, const float* __restrict__ s,
              float* __restrict__ part, int X, int Y, int Z, int C, int F,
              int nxt, int nyt, int nzt, int nbricks, int per, int dxs,
              int ngroups, int ftiles) {
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];
  int id = blockIdx.x;
  const int dx = (dxs >> 2 * (id % ngroups)) & 3;
  id /= ngroups;
  const int f0 = (id % ftiles) * TILE, c0 = (id / ftiles) * TILE;
  const int split = blockIdx.y;
  const int begin = split * per, n = min(nbricks, begin + per) - begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const unsigned base = (smem_addr(smem) + 1023u) & ~1023u;
  unsigned char* const stages = smem + (base - smem_addr(smem));
  const unsigned full0 = smem_addr(&bars[0]);
  auto load = [&](int it) {
    stage_brick(base + (it & 1) * STAGE_BYTES, full0 + (it & 1) * 8, &xmap,
                &gmap, brick_at(begin + it, nxt, nyt, nzt), dx, c0, f0);
  };
  if (threadIdx.x == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    mbar_fence_init();
    load(0);
  }
  __syncthreads();

  // warp w owns channels c0 + 16 * (w % 4) + [0, 16) and filters
  // f0 + 32 * (w / 4) + [0, 32) of all 9 taps
  const int mblk = warp & 3, nblk = warp >> 2;
  // ldmatrix.x4.trans row of this lane.  A (zhat, [voxel][c]): matrix
  // lane/8 is (k-half lane/16, c-half (lane/8)%2).  B (g1, [voxel][f]):
  // matrix lane/8 is (k-half (lane/8)%2, f-half lane/16).
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_slot = 2 * mblk + ((lane >> 3) & 1);
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_slot = 4 * nblk + (lane >> 4);
  const int ca = c0 + 16 * mblk + (lane >> 2);   // rows g of the accumulator

  float acc[GROUP_TAPS][N8][4];
#pragma unroll
  for (int t = 0; t < GROUP_TAPS; ++t)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][j][r] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    mbar_wait(full0 + buf * 8, (it >> 1) & 1);
    if (AFFINE) {
      affine_slab(stages + buf * STAGE_BYTES, a, s,
                  brick_at(begin + it, nxt, nyt, nzt), dx, X, Y, Z, C, c0);
      // the stage's next TMA writes must follow these generic writes
      fence_proxy_async();
      __syncthreads();
    }
    if (threadIdx.x == 0 && it + 1 < n) load(it + 1);
    const unsigned slab = base + buf * STAGE_BYTES;
    const unsigned grows = slab + SLAB_ROWS * ROW_BYTES;
#pragma unroll 1
    for (int col = 0; col < BX * BY; ++col) {   // one 16-voxel z run
      const int bx = col / BY, by = col % BY;
      unsigned b[N8][2];
      const int rb = col * BZ + b_k;
      ldsm_x4_trans(grows + swz128(rb, b_slot), b[0][0], b[0][1],
                    b[1][0], b[1][1]);
      ldsm_x4_trans(grows + swz128(rb, b_slot + 2), b[2][0], b[2][1],
                    b[3][0], b[3][1]);
#pragma unroll
      for (int t = 0; t < GROUP_TAPS; ++t) {
        const int dy = t / 3, dz = t % 3;
        const int ra = (bx * SY + by + dy) * SZ + dz + a_k;
        unsigned av[4];
        ldsm_x4_trans(slab + swz128(ra, a_slot), av[0], av[1], av[2],
                      av[3]);
#pragma unroll
        for (int j = 0; j < N8; ++j) mma_bf16(acc[t][j], av, b[j][0], b[j][1]);
      }
    }
    __syncthreads();   // the next iteration's loads overwrite this stage
  }

  // accumulator (row g or g+8, cols 2q and 2q+1 of each n8 tile), with
  // g = lane / 4 and q = lane % 4; F % 8 == 0 keeps each n8 tile in or out
  const int q = lane & 3;
#pragma unroll
  for (int t = 0; t < GROUP_TAPS; ++t) {
    const int tap = dx * 9 + t;
    float* out = part + ((size_t)split * 27 + tap) * C * F;
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      const int f = f0 + 32 * nblk + 8 * j + 2 * q;
      if (f >= F) continue;
      if (ca < C)
        *reinterpret_cast<float2*>(out + (size_t)ca * F + f) =
            make_float2(acc[t][j][0], acc[t][j][1]);
      if (ca + 8 < C)
        *reinterpret_cast<float2*>(out + (size_t)(ca + 8) * F + f) =
            make_float2(acc[t][j][2], acc[t][j][3]);
    }
  }
}

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int FBX = 1, FBY = 8, FBZ = 16;      // voxel brick
constexpr int FBV = FBX * FBY * FBZ;           // 128 voxels, 8 z runs
constexpr int FSY = FBY + 2, FSZ = FBZ + 2;    // slab of one dx
constexpr int FSLAB = FBX * FSY * FSZ;         // 180 rows
constexpr int FSTAGE = (FSLAB + FBV) * TILE;   // floats: slab, then g1
constexpr int FSTAGES = 2;
constexpr int FMA_SMEM = FSTAGES * FSTAGE * 4;   // 157,696 bytes

// Grid and splits as dw_mma_kernel's (x = (group, f tile, c tile), y = the
// split), over FBX x FBY x FBZ bricks.  Per brick thread t copies the
// 16-byte vector t % 16 (channels c0 + 4 (t % 16), or filters f0 + ...) of
// slab rows and g1 rows t / 16 + 16 j, one brick ahead into the other
// stage, then with the affine forms x * a + s on its real slab rows once
// they land; one barrier per brick publishes the stage.  Thread (tc, tf) =
// (t / 16, t % 16) owns channels c0 + 4 tc + [0, 4) and filters
// f0 + 4 tf + [0, 4) of the 9 taps: 144 accumulators.  For each z run it
// walks the 16 voxels keeping, per dy, the three slab rows z .. z + 2 that
// the 3 dz taps read: per voxel one g1 float4 and three new slab float4
// serve 144 FFMAs.  A warp reads two slab addresses (a broadcast) and 256
// contiguous g1 bytes per step, so no read conflicts.
template <bool AFFINE>
__global__ void __launch_bounds__(NTHREADS, 1)
dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ a, const float* __restrict__ s,
              float* __restrict__ part, int X, int Y, int Z, int C, int F,
              int nxt, int nyt, int nzt, int nbricks, int per, int dxs,
              int ngroups, int ftiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const stages = reinterpret_cast<float*>(smem);
  int id = blockIdx.x;
  const int dx = (dxs >> 2 * (id % ngroups)) & 3;
  id /= ngroups;
  const int f0 = (id % ftiles) * TILE, c0 = (id / ftiles) * TILE;
  const int split = blockIdx.y;
  const int begin = split * per, n = min(nbricks, begin + per) - begin;
  const int vec = threadIdx.x & 15, row0 = threadIdx.x >> 4;
  constexpr int RSTEP = NTHREADS / 16;

  // slab row r of brick k is the voxel (x0 + sx + dx - 1, y0 + hy - 1,
  // z0 + hz - 1)
  auto slab_voxel = [&](const Brick& k, int r, size_t& off) {
    const int hz = r % FSZ, q = r / FSZ;
    const int hy = q % FSY, sx = q / FSY;
    const int gx = k.x0 + sx + dx - 1, gy = k.y0 + hy - 1,
              gz = k.z0 + hz - 1;
    off = (((size_t)k.b * X + gx) * Y + gy) * Z + gz;
    return (unsigned)gx < (unsigned)X && (unsigned)gy < (unsigned)Y &&
           (unsigned)gz < (unsigned)Z;
  };
  // brick it's raw x slab (zeros outside the volume and beyond C) and g1
  // rows (zeros outside and beyond F) into its stage
  auto load = [&](int it) {
    float* const st = stages + (it & 1) * FSTAGE;
    const Brick k = brick_at<FBX, FBY, FBZ>(begin + it, nxt, nyt, nzt);
    const int c = c0 + 4 * vec, f = f0 + 4 * vec;
    for (int r = row0; r < FSLAB; r += RSTEP) {
      size_t off;
      const bool in = slab_voxel(k, r, off) && c < C;
      cp_async16(smem_addr(st + r * TILE + 4 * vec), in ? x + off * C + c : x,
                 in);
    }
    for (int r = row0; r < FBV; r += RSTEP) {
      const int bz = r % FBZ, q = r / FBZ;
      const int gx = k.x0 + q / FBY, gy = k.y0 + q % FBY, gz = k.z0 + bz;
      const bool in = gx < X && gy < Y && gz < Z && f < F;
      const size_t off = (((size_t)k.b * X + gx) * Y + gy) * Z + gz;
      cp_async16(smem_addr(st + (FSLAB + r) * TILE + 4 * vec),
                 in ? g + off * F + f : g, in);
    }
  };
  // x * a + s on the real slab rows this thread copied for brick it, each
  // step rounded as the plain version's
  auto affine = [&](int it) {
    float* const st = stages + (it & 1) * FSTAGE;
    const Brick k = brick_at<FBX, FBY, FBZ>(begin + it, nxt, nyt, nzt);
    const int c = c0 + 4 * vec;
    if (c >= C) return;
    const size_t ac = (size_t)k.b * C + c;
    float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a != nullptr) sc = __ldg(reinterpret_cast<const float4*>(a + ac));
    if (s != nullptr) sh = __ldg(reinterpret_cast<const float4*>(s + ac));
    for (int r = row0; r < FSLAB; r += RSTEP) {
      size_t off;
      if (!slab_voxel(k, r, off)) continue;
      float4 v = *reinterpret_cast<float4*>(st + r * TILE + 4 * vec);
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
      *reinterpret_cast<float4*>(st + r * TILE + 4 * vec) = v;
    }
  };

  const int tc = threadIdx.x >> 4, tf = threadIdx.x & 15;
  float acc[GROUP_TAPS][4][4];
#pragma unroll
  for (int t = 0; t < GROUP_TAPS; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;

  if (n > 0) load(0);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    cp_async_wait<0>();   // this thread's copies of brick it
    if (AFFINE) affine(it);
    // brick it is whole for every thread, and every thread is done with
    // brick it - 1, whose stage the load below refills
    __syncthreads();
    if (it + 1 < n) load(it + 1);
    cp_async_commit();
    const float* const st = stages + (it & 1) * FSTAGE;
#pragma unroll 1
    for (int col = 0; col < FBX * FBY; ++col) {   // one 16-voxel z run
      const float* const sp =
          st + ((col / FBY) * FSY + col % FBY) * FSZ * TILE + 4 * tc;
      const float* const gp = st + (FSLAB + col * FBZ) * TILE + 4 * tf;
      float4 av[3][3];   // [dy][hz % 3]: the slab rows the dz taps read
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int hz = 0; hz < 2; ++hz)
          av[dy][hz] =
              *reinterpret_cast<const float4*>(sp + (dy * FSZ + hz) * TILE);
#pragma unroll
      for (int z = 0; z < FBZ; ++z) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          av[dy][(z + 2) % 3] = *reinterpret_cast<const float4*>(
              sp + (dy * FSZ + z + 2) * TILE);
        const float4 gv = *reinterpret_cast<const float4*>(gp + z * TILE);
        const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4 zv = av[dy][(z + dz) % 3];
            const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[dy * 3 + dz][i][j] =
                    fmaf(zr[i], gr[j], acc[dy * 3 + dz][i][j]);
          }
      }
    }
  }

  // partial[split][tap][c][f]; F % 8 == 0 keeps each float4 in or out
  const int f = f0 + 4 * tf;
  if (f >= F) return;
#pragma unroll
  for (int t = 0; t < GROUP_TAPS; ++t) {
    float* const out = part + ((size_t)split * 27 + dx * 9 + t) * C * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 4 * tc + i;
      if (c < C)
        *reinterpret_cast<float4*>(out + (size_t)c * F + f) =
            make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2],
                        acc[t][i][3]);
    }
  }
}

}  // namespace

// bf16 variant.  x (B,X,Y,Z,C) and g (B,X,Y,Z,F) bf16, contiguous and
// 16-byte aligned; a, s (B,C) float32 (bf16 values) or null; part
// (splits,27,C,F) float32, splits = ceil(nbricks / per) with nbricks = B
// * ceil(X/4) * ceil(Y/4) * ceil(Z/16); the taps of the ngroups dx in
// dxs (two bits each) written, all 27 when they are 0, 1 and 2.  C and F
// are multiples of 8.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_dw_bf16(const void* x, const void* g,
                                     const float* a, const float* s,
                                     float* part, int B, int X, int Y, int Z,
                                     int C, int F, int per, int dxs,
                                     int ngroups, void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || F <= 0 || per <= 0 ||
      ngroups <= 0 || ngroups > 15)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < ngroups; ++i)
    if (((dxs >> 2 * i) & 3) > 2) return (int)cudaErrorInvalidValue;
  const int nxt = (X + BX - 1) / BX, nyt = (Y + BY - 1) / BY,
            nzt = (Z + BZ - 1) / BZ;
  const long long nbricks = (long long)B * nxt * nyt * nzt;
  const long long splits = (nbricks + per - 1) / per;
  const int ctiles = (C + TILE - 1) / TILE, ftiles = (F + TILE - 1) / TILE;
  const long long tiles = (long long)ngroups * ctiles * ftiles;
  if (nbricks > 0x7fffffffLL || splits > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xmap, gmap;
  cudaError_t err = encode_volume(&xmap, x, B, X, Y, Z, C, TILE, SZ, SY, BX,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_volume(&gmap, g, B, X, Y, Z, F, TILE, BZ, BY, BX,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const bool affine = a != nullptr || s != nullptr;
  const auto kernel = affine ? dw_mma_kernel<true> : dw_mma_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)splits);
  kernel<<<grid, NTHREADS, MMA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, gmap, a, s, part, X, Y, Z, C, F, nxt, nyt, nzt, (int)nbricks, per,
      dxs, ngroups, ftiles);
  return (int)cudaGetLastError();
}

// f32 variant.  x (B,X,Y,Z,C) and g (B,X,Y,Z,F) float32, contiguous and
// 16-byte aligned; a, s (B,C) float32 or null; part (splits,27,C,F)
// float32, splits = ceil(nbricks / per) with nbricks = B * ceil(X/bx) *
// ceil(Y/by) * ceil(Z/bz); the taps of the ngroups dx in dxs written, as
// for bf16.  The plan (dw_fma_plan): the brick (bx, by, bz), the ring's
// stages and the dynamic shared memory, which must be the compiled ones.
// C and F are multiples of 8.  Returns a cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_dw_f32(const float* x, const float* g,
                                    const float* a, const float* s,
                                    float* part, int B, int X, int Y, int Z,
                                    int C, int F, int bx, int by, int bz,
                                    int per, int dxs, int ngroups, int stages,
                                    int smem, void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || F <= 0 || per <= 0 ||
      C % 8 || F % 8 || ngroups <= 0 || ngroups > 15 || bx != FBX ||
      by != FBY || bz != FBZ || stages != FSTAGES || smem != FMA_SMEM)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < ngroups; ++i)
    if (((dxs >> 2 * i) & 3) > 2) return (int)cudaErrorInvalidValue;
  const int nxt = (X + FBX - 1) / FBX, nyt = (Y + FBY - 1) / FBY,
            nzt = (Z + FBZ - 1) / FBZ;
  const long long nbricks = (long long)B * nxt * nyt * nzt;
  const long long splits = (nbricks + per - 1) / per;
  const int ctiles = (C + TILE - 1) / TILE, ftiles = (F + TILE - 1) / TILE;
  const long long tiles = (long long)ngroups * ctiles * ftiles;
  if (nbricks > 0x7fffffffLL || splits > 65535 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const bool affine = a != nullptr || s != nullptr;
  const auto kernel = affine ? dw_fma_kernel<true> : dw_fma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)splits);
  kernel<<<grid, NTHREADS, FMA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, g, a, s, part, X, Y, Z, C, F, nxt, nyt, nzt, (int)nbricks, per, dxs,
      ngroups, ftiles);
  return (int)cudaGetLastError();
}
