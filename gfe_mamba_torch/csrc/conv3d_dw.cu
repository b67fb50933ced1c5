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

// f32 (dw_fma_kernel, for checks; TF32 would lose the 1e-4 parity): one
// tap per block, a 64 x 64 tile, a voxel range, zhat and g1 staged as f32
// per 32-voxel chunk and a 4 x 4 FMA tile per thread on the CUDA cores.
//
// Both write one f32 partial per (split, tap, c, f), every element once;
// the caller sums the splits in a fixed order, so dw is deterministic (no
// atomics).  No TPU layout (z-pair packing, parity blocks) is kept.  The
// TMA, mbarrier, ldmatrix / mma.sync and affine helpers come from
// hopper.cuh, shared with K1.

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
// nzt) grid of BX x BY x BZ bricks
__device__ __forceinline__ Brick brick_at(int i, int nxt, int nyt, int nzt) {
  Brick r;
  r.z0 = (i % nzt) * BZ;
  i /= nzt;
  r.y0 = (i % nyt) * BY;
  i /= nyt;
  r.x0 = (i % nxt) * BX;
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

constexpr int KC = 32;   // voxels per shared-memory chunk

__global__ void __launch_bounds__(NTHREADS)
dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ a, const float* __restrict__ s,
              float* __restrict__ part, int X, int Y, int Z, int C, int F,
              int voxels, int chunk, int ctiles, int ftiles) {
  constexpr int VEC = 4;
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
      alignas(16) float vals[VEC] = {0.f, 0.f, 0.f, 0.f};
      if (v < v_end && c < C) {
        const int z = v % Z;
        int rest = v / Z;
        const int y = rest % Y;
        rest /= Y;
        const int xx = rest % X, b = rest / X;
        const int sx = xx + di, sy = y + dj, sz = z + dk;
        if (sx >= 0 && sx < X && sy >= 0 && sy < Y && sz >= 0 && sz < Z) {
          const size_t off = ((((size_t)b * X + sx) * Y + sy) * Z + sz) * C + c;
          *reinterpret_cast<float4*>(vals) =
              __ldg(reinterpret_cast<const float4*>(x + off));
          // rounded after the scale and after the shift, as the plain
          // version does (no fma contraction)
          const size_t ac = (size_t)b * C + c;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            if (a != nullptr) vals[j] = __fmul_rn(vals[j], a[ac + j]);
            if (s != nullptr) vals[j] = __fadd_rn(vals[j], s[ac + j]);
          }
        }
      }
      *reinterpret_cast<float4*>(&As[r][cv]) =
          *reinterpret_cast<const float4*>(vals);
    }
    // g1 rows (unshifted)
    for (int i = threadIdx.x; i < KC * (TILE / VEC); i += NTHREADS) {
      const int r = i / (TILE / VEC), fv = (i % (TILE / VEC)) * VEC;
      const int v = v0 + r, f = f0 + fv;
      float4 vals = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < v_end && f < F)
        vals = __ldg(reinterpret_cast<const float4*>(g + (size_t)v * F + f));
      *reinterpret_cast<float4*>(&Bs[r][fv]) = vals;
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
// float32, every element written.  C and F are multiples of 8.  Returns a
// cudaError_t code (0 on success).
extern "C" int gfe_conv3x3x3_dw_f32(const float* x, const float* g,
                                    const float* a, const float* s,
                                    float* part, int B, int X, int Y, int Z,
                                    int C, int F, int splits, void* stream) {
  const long long voxels = (long long)B * X * Y * Z;
  if (voxels <= 0 || voxels > 0x7fffffffLL || splits <= 0)
    return (int)cudaErrorInvalidValue;
  long long chunk = (voxels + splits - 1) / splits;
  chunk = (chunk + KC - 1) / KC * KC;
  const int ctiles = (C + TILE - 1) / TILE, ftiles = (F + TILE - 1) / TILE;
  const long long tiles = 27LL * ctiles * ftiles;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)splits, (unsigned)tiles);
  dw_fma_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, g, a, s, part, X, Y, Z, C, F, (int)voxels, (int)chunk, ctiles,
      ftiles);
  return (int)cudaGetLastError();
}
