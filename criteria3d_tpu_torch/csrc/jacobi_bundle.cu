// Bundled Jacobi sweeps of the catchment water system, for Hopper (sm_90a).
//
// Replaces the TPU kernel criteria3d_tpu/solver/pallas_jacobi.py:jacobi_bundle
// (kernel body _kernel): K Jacobi sweeps of the 10-point stencil
//
//   x <- mask * (b + c_up*x[l-1] + c_down*x[l+1]
//                + sum_k c_lat[k]*x[r+dr_k, c+dc_k])
//
// with the lateral offsets in LATERAL_OFFSETS order (N, S, W, E, NW, NE, SW,
// SE), layer 0 clamped to >= 0 before the mask multiply, and the
// psi-weighted L1 norm of the LAST sweep only,
//   sum |x - x_prev| * (|x| > 1 ? 1/|x| : 1) * mask,
// leaving out of the norm the outer `halo` ring of the box when halo > 0
// (pallas_jacobi.py:113-122: that ring is owned by a neighbouring device in
// the sharded loop; it still sweeps). Every array is float32, (L, R, C)
// row-major; c_lat is (8, L, R, C).
//
// Numerics: each term is added in the order above with a separate multiply
// and add. The library is built with --fmad=false so that nvcc does not
// contract them into FMAs: x then equals the plain PyTorch version
// (solver/jacobi_bundle.py:jacobi_bundle_reference) bit for bit. Neighbours
// outside the box read as 0, which is what the TPU kernel's wrap-around
// reads give, since the assembly zeroes c_up[0], c_down[L-1] and every
// lateral coefficient whose neighbour is missing. The norm is reduced
// without atomics, in a fixed order, so it is the same from run to run.
//
// Bound: device memory. A bundle must read 13 arrays (b, c_up, c_down, mask,
// x, 8 x c_lat) and write x once: 14 x L*R*C x 4 bytes, about 231 MB at the
// 7 x 768 x 768 catchment box, 69 us at 3.35 TB/s; its ~21 flops per node
// and sweep are far below the float32 rate.
//
// Design: temporal blocking. The (row, col) plane is cut into TI x TI tiles
// (TI a multiple of 4). A tile is staged with an S-cell ring of x (TW =
// TI + 2S cells a side) and the 12 coefficient arrays of its inner
// (TW-2) x (TW-2) columns ONCE, then up to S sweeps run on chip: after sweep
// s only the cells within s of the tile's edge are stale, so sweep s updates
// ring >= s (the outermost ring, x only, is never swept and needs no
// coefficients) and the TI x TI interior is exact after S sweeps. Only x is
// exchanged between threads, through a double-buffered shared-memory copy;
// cells outside the box are never swept and stay 0, as the plain version
// reads them. A bundle takes ceil(K / S) launches, the last of which may run
// fewer sweeps and then sweeps only the rings they need. The last launch
// also writes one norm partial per (row, col) column (the sum over l, in
// order, of dx*w*m) to a plane of R*C floats, which plane_sum_kernel and
// sum_kernel reduce with the fixed tree of the per-sweep design below:
// blocks of 256 consecutive columns, then one block of 1024. So x and the
// norm are bit-equal to that design.
//
// Two kernels carry it:
// - tiled_resident_kernel<L> (L <= 7, C a multiple of 4: the main path): one
//   persistent block per SM walks the tiles in row-major order, 132 apart,
//   so the tiles in flight share their rings through L2. One thread owns one
//   column and keeps its 12 x L coefficients in registers (84 at L = 7, at
//   most 128 registers for 484 threads; ptxas spills ~100 bytes at L = 7).
//   Tiles whose interior mask is 0 in every layer (outside the catchment:
//   tile_live_kernel finds them once per bundle) are skipped.
//   The tile arrives by TMA (13 boxes, out-of-box cells zero-filled) into a
//   staging area that is free once the tile is in registers, so the next
//   tile's loads run while this one sweeps. TMA refuses a box whose first
//   column is not on 16 bytes (an illegal-instruction fault on the card),
//   so the boxes start D = (-S) mod 4 cells left of the tile.
// - tiled_sweeps_kernel (any L, any C): one block per tile, coefficients in
//   shared memory, staged by 4-byte cp.async.
//
// The caller picks TI and S per L (solver/jacobi_bundle.py:plan_tiles):
// shared memory (TileLayout) at most the 232,448 bytes of a block, at most
// 512 threads; at L = 7, K = 8: TI = 16, S = 4, 226,688 bytes. The bytes
// requested per launch are about (12*(TW-2)*CP + TW*XP) / TI^2 + 1 box
// arrays (CP, XP: the row pitches), 28 at L = 7, so 56 per bundle against
// 112 for the per-sweep design and 14 at the bound.
//
// The per-sweep design (c3d_jacobi_bundle_per_sweep, sweep_kernel) is the
// first, simple one: one launch per sweep, ping-ponging x through device
// memory, K times the bound's bytes. It is kept for measuring the tiled
// design against, and for holding it bit for bit; the main path never runs
// it.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLateral = 8;
constexpr int kCoef = 12;               // b, c_up, c_down, mask, 8 x c_lat
constexpr int kNormThreads = 256;       // columns per first-stage norm block
constexpr int kSumThreads = 1024;
constexpr int kResidentThreads = 512;   // at most 128 registers a thread
constexpr int kResidentMaxL = 7;        // 12 x 7 coefficients in registers

// Lateral neighbour k of LATERAL_OFFSETS: N, S, W, E, NW, NE, SW, SE.
__host__ __device__ constexpr int lat_dr(int k) {
  return (k == 0 || k == 4 || k == 5) ? -1 : ((k == 1 || k == 6 || k == 7) ? 1 : 0);
}
__host__ __device__ constexpr int lat_dc(int k) {
  return (k == 2 || k == 4 || k == 6) ? -1 : ((k == 3 || k == 5 || k == 7) ? 1 : 0);
}

// Sum of blockDim.x values in shared memory, in a fixed tree order; the
// result lands in red[0]. blockDim.x must be a power of two.
__device__ void block_sum(float* red) {
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + s];
    __syncthreads();
  }
}

__device__ __forceinline__ bool in_norm(int r, int c, int R, int C, int halo) {
  return r >= halo && r < R - halo && c >= halo && c < C - halo;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous 4-byte copy into shared memory; zero-fills when !ok (no
// bytes are read from src then).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// TMA load of the 3-D box (col, row, layer) at (c, r, 0). The box must
// start on a 16-byte column; the card faults otherwise.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(r), "r"(0), "r"(smem_addr(bar))
      : "memory");
}

// TMA load of the 4-D box (col, row, layer, 1) at (c, r, 0, k).
__device__ __forceinline__ void tma_load_4d(float* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c, int r, int k) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c), "r"(r), "r"(0), "r"(k),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Shared-memory layout of a tiled block, in floats after a 128-byte head
// that holds the mbarrier: the 12 coefficient boxes, then three x buffers
// (the staged box and the two sweep buffers). TMA boxes must start on a
// 16-byte column (TI is a multiple of 4, so every tile's columns start
// D = (-S) mod 4 cells after a multiple of 4) and are written densely, so a
// row holds D + the tile's columns, padded to a multiple of 4; x-tile column
// j is row entry j + D in both the x and the coefficient rows. Each region
// starts on 128 bytes.
struct TileLayout {
  int TW, CW, D, XP, CP;   // x tile side, coefficient tile side, lead, row pitches
  int CA, XA;              // floats of one coefficient array, of one x buffer
  __host__ __device__ TileLayout(int L, int TI, int S)
      : TW(TI + 2 * S), CW(TI + 2 * S - 2), D((4 - S % 4) % 4),
        XP((D + TW + 3) / 4 * 4), CP((D + TW - 1 + 3) / 4 * 4),
        CA((L * CW * CP + 31) / 32 * 32), XA((L * TW * XP + 31) / 32 * 32) {}
  __host__ __device__ int64_t bytes() const {
    return 128 + 4 * (static_cast<int64_t>(kCoef) * CA + 3 * static_cast<int64_t>(XA));
  }
};

// Boxes: (CP, CW, L) of b, c_up, c_down, mask; (CP, CW, L, 1) of c_lat,
// (8, L, R, C); (XP, TW, L) of x; all start at column c0 - D.
struct TileMaps {
  CUtensorMap coef[4], lat, x;
};

// One sweep of one (row, col) column of the x tile, layer by layer, in the
// plain version's term order. Reads the old x from src (row pitch XP, layer
// stride NXP, the column at xi) and coefficient a of layer l as cf(a, l).
// On the bundle's last sweep the column goes to y (layer stride `plane`,
// the column at g) and its norm terms, summed over l in order, are returned
// (0 unless `counted`); on the others it goes to dst. kL > 0 fixes the layer
// count at compile time; kL = 0 takes L.
template <int kL, typename Coef>
__device__ __forceinline__ float sweep_column(const float* src, float* dst, float* y, int L,
                                              int NXP, int XP, int xi, int64_t plane,
                                              int64_t g, bool last, bool counted, Coef cf) {
  const int n = kL > 0 ? kL : L;
  float local = 0.0f;
  float x_up = 0.0f;        // x[l-1] of this column (0 above layer 0)
  float x_mid = src[xi];    // x[l]
#pragma unroll
  for (int l = 0; l < n; ++l) {
    const float* xl = src + l * NXP + xi;
    const float x_dn = (l + 1 < n) ? xl[NXP] : 0.0f;
    float acc = cf(0, l);
    acc = acc + cf(1, l) * x_up;
    acc = acc + cf(2, l) * x_dn;
#pragma unroll
    for (int k = 0; k < kLateral; ++k) acc = acc + cf(4 + k, l) * xl[lat_dr(k) * XP + lat_dc(k)];
    // surface clamp psi >= 0 (a NaN passes through, as in the plain version)
    if (l == 0 && acc < 0.0f) acc = 0.0f;
    const float m = cf(3, l);
    const float xn = acc * m;
    if (last) {
      y[l * plane + g] = xn;
      if (counted) {
        const float dx = fabsf(xn - x_mid);
        const float apsi = fabsf(xn);
        const float w = apsi > 1.0f ? 1.0f / apsi : 1.0f;
        local = local + dx * w * m;
      }
    } else {
      dst[l * NXP + xi] = xn;
    }
    x_up = x_mid;
    x_mid = x_dn;
  }
  return local;
}

// The generic tiled launch: `sweeps` (1..S) sweeps from x into y on tiles
// cut for S, any L, staged by cp.async. blockDim.x == CW*CW. With
// norm_plane, this is the bundle's last launch and each interior column
// writes its norm partial there.
__global__ void tiled_sweeps_kernel(const float* __restrict__ b,
                                    const float* __restrict__ c_up,
                                    const float* __restrict__ c_down,
                                    const float* __restrict__ c_lat,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ x,
                                    float* __restrict__ y,
                                    float* __restrict__ norm_plane,
                                    int L, int R, int C, int TI, int S,
                                    int sweeps, int halo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TileLayout t(L, TI, S);
  float* coef = reinterpret_cast<float*>(smem_raw + 128);
  float* xa = coef + kCoef * t.CA + t.XA;
  float* xb = xa + t.XA;
  const int NXP = t.TW * t.XP;    // floats per layer of an x buffer
  const int NCP = t.CW * t.CP;    // floats per layer of a coefficient array
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int64_t box = plane * L;
  const int r0 = static_cast<int>(blockIdx.y) * TI - S;   // box row of tile row 0
  const int c0 = static_cast<int>(blockIdx.x) * TI - S;
  const int tid = threadIdx.x;

  // ---- stage: each thread the coefficients of one computed column, then
  // the x tile (all threads); cells outside the box fill 0
  {
    const int i = tid / t.CW + 1;   // the column's place in the x tile
    const int j = tid - (i - 1) * t.CW + 1;
    const int r = r0 + i;
    const int c = c0 + j;
    const bool inbox = r >= 0 && r < R && c >= 0 && c < C;
    const int64_t g = inbox ? static_cast<int64_t>(r) * C + c : 0;
    const int cofs = (i - 1) * t.CP + j + t.D;
    const float* arrays[4] = {b, c_up, c_down, mask};
    for (int l = 0; l < L; ++l) {
      const int64_t gi = l * plane + g;
      float* dst = coef + l * NCP + cofs;
#pragma unroll
      for (int a = 0; a < 4; ++a) cp_async_f32(dst + a * t.CA, arrays[a] + gi, inbox);
#pragma unroll
      for (int k = 0; k < kLateral; ++k)
        cp_async_f32(dst + (4 + k) * t.CA, c_lat + k * box + gi, inbox);
    }
    const int nx = t.TW * t.TW;
    for (int e = tid; e < L * nx; e += blockDim.x) {
      const int l = e / nx;
      const int cell = e - l * nx;
      const int ri = cell / t.TW;
      const int ci = cell - ri * t.TW;
      const int rr = r0 + ri;
      const int cc = c0 + ci;
      const bool ok = rr >= 0 && rr < R && cc >= 0 && cc < C;
      const int64_t gi = ok ? l * plane + static_cast<int64_t>(rr) * C + cc : 0;
      cp_async_f32(xa + l * NXP + ri * t.XP + ci + t.D, x + gi, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  // the second buffer starts as a copy, so cells outside the box stay 0 in both
  for (int e = tid; e < t.XA; e += blockDim.x) xb[e] = xa[e];
  __syncthreads();

  // ---- sweeps. Sweep s of `sweeps` updates the square of the x tile at
  // ring >= S - sweeps + s (the last one the TI x TI interior); its cells go
  // to the first threads of the block, so the warps that idle are whole.
  const int CA = t.CA;
  float* src = xa;
  float* dst = xb;
  for (int s = 1; s <= sweeps; ++s) {
    const bool last = s == sweeps;
    const int ring = S - sweeps + s;
    const int n = t.TW - 2 * ring;   // side of the square swept now
    const int si = ring + tid / n;   // the cell in the x tile
    const int sj = ring + tid % n;
    const int sr = r0 + si;
    const int sc = c0 + sj;
    if (tid < n * n && sr >= 0 && sr < R && sc >= 0 && sc < C) {
      const int64_t sg = static_cast<int64_t>(sr) * C + sc;
      const int xi = si * t.XP + sj + t.D;
      const int ci = (si - 1) * t.CP + sj + t.D;
      const bool counted = last && norm_plane != nullptr && in_norm(sr, sc, R, C, halo);
      const float local =
          sweep_column<0>(src, dst, y, L, NXP, t.XP, xi, plane, sg, last, counted,
                          [&](int a, int l) { return coef[a * CA + l * NCP + ci]; });
      if (last && norm_plane != nullptr) norm_plane[sg] = local;
    }
    __syncthreads();
    float* tmp = dst;
    dst = src;
    src = tmp;
  }
}

// Issue the 13 TMA loads of one tile into the staging area (one thread).
__device__ __forceinline__ void stage_tile(const TileMaps& maps, uint64_t* bar, float* stage,
                                           float* xs, const TileLayout& t, uint32_t bytes,
                                           int r0, int c0) {
  const int cs = c0 - t.D;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  for (int a = 0; a < 4; ++a) tma_load_3d(stage + a * t.CA, maps.coef[a], bar, cs, r0 + 1);
  for (int k = 0; k < kLateral; ++k)
    tma_load_4d(stage + (4 + k) * t.CA, maps.lat, bar, cs, r0 + 1, k);
  tma_load_3d(xs, maps.x, bar, cs, r0);
}

// live[tile] = 0 when the mask is 0 in every layer of the tile's TI x TI
// interior (a NaN mask counts as live), else 1. One block per tile.
__global__ void tile_live_kernel(const float* __restrict__ mask, unsigned char* __restrict__ live,
                                 int L, int R, int C, int TI, int tiles_x) {
  const int r0 = static_cast<int>(blockIdx.x) / tiles_x * TI;
  const int c0 = static_cast<int>(blockIdx.x) % tiles_x * TI;
  const int64_t plane = static_cast<int64_t>(R) * C;
  bool any = false;
  for (int e = threadIdx.x; e < L * TI * TI && !any; e += blockDim.x) {
    const int l = e / (TI * TI);
    const int q = e - l * TI * TI;
    const int r = r0 + q / TI;
    const int c = c0 + q % TI;
    any = r < R && c < C && !(mask[l * plane + static_cast<int64_t>(r) * C + c] == 0.0f);
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.x] = any ? 1 : 0;
}

// The resident tiled launch, for L = kL <= 7 and tensors TMA can read: one
// persistent block per SM walks the tiles. Each thread keeps its column's
// 12 x kL coefficients in registers, so the sweeps read only x from shared
// memory, and the staging area is free as soon as a tile is in registers:
// the TMA loads of the block's next tile run while this one sweeps.
// A tile whose interior mask is 0 everywhere (live[tile] == 0, from
// tile_live_kernel) is neither loaded nor swept: its x and norm partials are
// written as +0.0. The plain version gives acc * 0 there, which is +-0.0
// whenever acc is finite; the assembly zeroes every coefficient outside the
// catchment and x is 0 there, so only a NaN or an infinity in the inputs
// would be lost. blockDim.x == CW*CW <= 512.
template <int kL>
__global__ void __launch_bounds__(kResidentThreads, 1)
    tiled_resident_kernel(const __grid_constant__ TileMaps maps, float* __restrict__ y,
                          float* __restrict__ norm_plane,
                          const unsigned char* __restrict__ live, int R, int C, int TI,
                          int S, int sweeps, int halo, int tiles_x, int tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TileLayout t(kL, TI, S);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* stage = reinterpret_cast<float*>(smem_raw + 128);
  float* xs = stage + kCoef * t.CA;
  float* xa = xs + t.XA;
  float* xb = xa + t.XA;
  const int NXP = t.TW * t.XP;
  const int NCP = t.CW * t.CP;
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int tid = threadIdx.x;
  const int i = tid / t.CW + 1;   // this thread's column in the x tile
  const int j = tid - (i - 1) * t.CW + 1;
  const int ring = min(min(i, j), min(t.TW - 1 - i, t.TW - 1 - j));
  const int xi = i * t.XP + j + t.D;
  const int ci = (i - 1) * t.CP + j + t.D;
  const uint32_t bytes = 4u * (kCoef * kL * NCP + kL * NXP);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto next_live = [&](int from) {   // this block's next tile to load
    while (from < tiles && !live[from]) from += gridDim.x;
    return from;
  };
  int staged = next_live(blockIdx.x);
  if (tid == 0 && staged < tiles)
    stage_tile(maps, bar, stage, xs, t, bytes, (staged / tiles_x) * TI - S,
               (staged % tiles_x) * TI - S);
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (!live[tile]) {
      const int r0 = (tile / tiles_x) * TI;
      const int c0 = (tile % tiles_x) * TI;
      for (int e = tid; e < kL * TI * TI; e += blockDim.x) {
        const int l = e / (TI * TI);
        const int r = r0 + (e - l * TI * TI) / TI;
        const int c = c0 + (e - l * TI * TI) % TI;
        if (r < R && c < C) {
          const int64_t g = static_cast<int64_t>(r) * C + c;
          y[l * plane + g] = 0.0f;
          if (l == 0 && norm_plane != nullptr) norm_plane[g] = 0.0f;
        }
      }
      continue;
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    float cf[kCoef][kL];
#pragma unroll
    for (int a = 0; a < kCoef; ++a)
#pragma unroll
      for (int l = 0; l < kL; ++l) cf[a][l] = stage[a * t.CA + l * NCP + ci];
    for (int e = tid; e < t.XA; e += blockDim.x) {
      const float v = xs[e];
      xa[e] = v;
      xb[e] = v;
    }
    __syncthreads();   // the staging area is free: fetch the next tile
    staged = next_live(tile + gridDim.x);
    if (tid == 0 && staged < tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_tile(maps, bar, stage, xs, t, bytes, (staged / tiles_x) * TI - S,
                 (staged % tiles_x) * TI - S);
    }
    const int r = (tile / tiles_x) * TI - S + i;
    const int c = (tile % tiles_x) * TI - S + j;
    const bool inbox = r >= 0 && r < R && c >= 0 && c < C;
    const int64_t g = static_cast<int64_t>(r) * C + c;
    const bool counted = norm_plane != nullptr && in_norm(r, c, R, C, halo);
    float* src = xa;
    float* dst = xb;
    for (int s = 1; s <= sweeps; ++s) {
      const bool last = s == sweeps;
      // rings the remaining sweeps need: ring >= S is the interior at the end
      if (inbox && ring >= S - sweeps + s) {
        const float local =
            sweep_column<kL>(src, dst, y, kL, NXP, t.XP, xi, plane, g, last, counted,
                             [&](int a, int l) { return cf[a][l]; });
        if (last && norm_plane != nullptr) norm_plane[g] = local;
      }
      __syncthreads();
      float* tmp = dst;
      dst = src;
      src = tmp;
    }
  }
}

// First norm stage: partial[block] = sum of 256 consecutive norm_plane
// entries, in the tree order of sweep_kernel<true>'s per-block sum.
__global__ void plane_sum_kernel(const float* __restrict__ norm_plane, int64_t n,
                                 float* __restrict__ partial) {
  extern __shared__ float red[];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  red[threadIdx.x] = col < n ? norm_plane[col] : 0.0f;
  __syncthreads();
  block_sum(red);
  if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

// One sweep of the per-sweep design: one thread per (r, c) column.
template <bool kLast>
__global__ void sweep_kernel(const float* __restrict__ b,
                             const float* __restrict__ c_up,
                             const float* __restrict__ c_down,
                             const float* __restrict__ c_lat,
                             const float* __restrict__ mask,
                             const float* __restrict__ x,
                             float* __restrict__ y,
                             float* __restrict__ partial,
                             int L, int R, int C, int halo) {
  extern __shared__ float red[];
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int64_t box = plane * L;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float local = 0.0f;
  if (col < plane) {
    const int r = static_cast<int>(col / C);
    const int c = static_cast<int>(col - static_cast<int64_t>(r) * C);
    const bool counted = in_norm(r, c, R, C, halo);
    int64_t nb_off[kLateral];
    bool nb_ok[kLateral];
#pragma unroll
    for (int k = 0; k < kLateral; ++k) {
      const int rr = r + lat_dr(k);
      const int cc = c + lat_dc(k);
      nb_ok[k] = rr >= 0 && rr < R && cc >= 0 && cc < C;
      nb_off[k] = static_cast<int64_t>(lat_dr(k)) * C + lat_dc(k);
    }
    float x_up = 0.0f;       // x[l-1] of this column (0 above layer 0)
    float x_mid = x[col];    // x[l]
    for (int l = 0; l < L; ++l) {
      const int64_t i = static_cast<int64_t>(l) * plane + col;
      const float x_dn = (l + 1 < L) ? x[i + plane] : 0.0f;
      float acc = b[i];
      acc = acc + c_up[i] * x_up;
      acc = acc + c_down[i] * x_dn;
#pragma unroll
      for (int k = 0; k < kLateral; ++k) {
        const float nb = nb_ok[k] ? x[i + nb_off[k]] : 0.0f;
        acc = acc + c_lat[k * box + i] * nb;
      }
      // surface clamp psi >= 0 (a NaN passes through, as in the plain version)
      if (l == 0 && acc < 0.0f) acc = 0.0f;
      const float m = mask[i];
      const float xn = acc * m;
      y[i] = xn;
      if (kLast && counted) {
        const float dx = fabsf(xn - x_mid);
        const float apsi = fabsf(xn);
        const float w = apsi > 1.0f ? 1.0f / apsi : 1.0f;
        local = local + dx * w * m;
      }
      x_up = x_mid;
      x_mid = x_dn;
    }
  }
  if (kLast) {
    red[threadIdx.x] = local;
    __syncthreads();
    block_sum(red);
    if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
  }
}

// One block: out[0] = sum of the n per-block partial norms, in a fixed order.
__global__ void sum_kernel(const float* __restrict__ partial, int n,
                           float* __restrict__ out) {
  extern __shared__ float red[];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s = s + partial[i];
  red[threadIdx.x] = s;
  __syncthreads();
  block_sum(red);
  if (threadIdx.x == 0) out[0] = red[0];
}

bool bad_box(int L, int R, int C, int K) { return L < 1 || R < 1 || C < 1 || K < 1; }

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of an (n, L, R, C) float32 array (n = 1: three dimensions) with
// boxes of (pitch, rows, L[, 1]); reads outside the array fill 0.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const float* base, int n, int L,
                int R, int C, int pitch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(n)};
  const cuuint64_t row = 4ull * C;
  const cuuint64_t strides[3] = {row, row * R, row * R * L};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(pitch), static_cast<cuuint32_t>(rows),
                               static_cast<cuuint32_t>(L), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n > 1 ? 4 : 3,
            const_cast<float*>(base), dims, strides, boxes, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Whether c3d_jacobi_bundle runs the resident kernel (1) or the generic one
// (0) for these arrays and this tile: the resident kernel needs L <= 7, at
// most 512 threads, and tensors TMA can read (rows of a multiple of 16 bytes,
// 16-byte aligned bases).
extern "C" int c3d_jacobi_bundle_resident(int L, int C, int TI, int S, const void* b,
                                          const void* c_up, const void* c_down,
                                          const void* c_lat, const void* mask,
                                          const void* x0, const void* tmp, const void* out) {
  const int cw = TI + 2 * S - 2;
  return L <= kResidentMaxL && cw * cw <= kResidentThreads && C % 4 == 0 && aligned16(b) &&
         aligned16(c_up) && aligned16(c_down) && aligned16(c_lat) && aligned16(mask) &&
         aligned16(x0) && aligned16(tmp) && aligned16(out) && encode_tiled() != nullptr;
}

namespace {

using ResidentKernel = void (*)(TileMaps, float*, float*, const unsigned char*, int, int, int,
                                int, int, int, int, int);

ResidentKernel resident_kernel(int L) {
  switch (L) {
    case 1: return tiled_resident_kernel<1>;
    case 2: return tiled_resident_kernel<2>;
    case 3: return tiled_resident_kernel<3>;
    case 4: return tiled_resident_kernel<4>;
    case 5: return tiled_resident_kernel<5>;
    case 6: return tiled_resident_kernel<6>;
    default: return tiled_resident_kernel<7>;
  }
}

// The tensor maps of a bundle: the coefficients, and x for each of its
// sources x0, tmp and out.
CUresult encode_maps(TileMaps maps[3], const TileLayout& t, const float* b, const float* c_up,
                     const float* c_down, const float* c_lat, const float* mask,
                     const float* const xs[3], int L, int R, int C) {
  const EncodeTiled fn = encode_tiled();
  const float* coefs[4] = {b, c_up, c_down, mask};
  for (int a = 0; a < 4; ++a) {
    const CUresult res = encode(fn, &maps[0].coef[a], coefs[a], 1, L, R, C, t.CP, t.CW);
    if (res != CUDA_SUCCESS) return res;
  }
  CUresult res = encode(fn, &maps[0].lat, c_lat, kLateral, L, R, C, t.CP, t.CW);
  if (res != CUDA_SUCCESS) return res;
  maps[2] = maps[1] = maps[0];
  for (int v = 0; v < 3 && res == CUDA_SUCCESS; ++v)
    res = encode(fn, &maps[v].x, xs[v], 1, L, R, C, t.XP, t.TW);
  return res;
}

}  // namespace

// The tiled design: K sweeps from x0 in ceil(K / S) launches over TI x TI
// tiles (TI a multiple of 4); the result goes to `out`, `tmp` is the second
// ping-pong buffer (both L*R*C floats), `norm_plane` holds R*C floats,
// `partial` ceil(R*C / 256), `norm` one and `tile_live` one byte per tile.
// Launches on `stream` and does not synchronise; returns the CUDA error
// code (0 = ok), also when the shared memory the tile needs is refused, or
// the CUresult of a refused tensor map.
extern "C" int c3d_jacobi_bundle(const float* b, const float* c_up,
                                 const float* c_down, const float* c_lat,
                                 const float* mask, const float* x0,
                                 float* out, float* tmp, float* norm_plane,
                                 float* partial, float* norm, unsigned char* tile_live,
                                 int L, int R, int C, int K, int halo, int TI, int S,
                                 void* stream) {
  const int cw = TI + 2 * S - 2;
  if (bad_box(L, R, C, K) || TI < 4 || TI % 4 != 0 || S < 1 || cw * cw > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TileLayout t(L, TI, S);
  const int64_t smem = t.bytes();
  if (smem > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool resident =
      c3d_jacobi_bundle_resident(L, C, TI, S, b, c_up, c_down, c_lat, mask, x0, tmp, out);
  const ResidentKernel rk = resident_kernel(L);
  cudaError_t err =
      resident ? cudaFuncSetAttribute(rk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem))
               : cudaFuncSetAttribute(tiled_sweeps_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xs[3] = {x0, tmp, out};   // the sources of x, launch by launch
  TileMaps maps[3] = {};
  int sms = 0;
  if (resident) {
    const CUresult res = encode_maps(maps, t, b, c_up, c_down, c_lat, mask, xs, L, R, C);
    if (res != CUDA_SUCCESS) return static_cast<int>(res);
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_x = (C + TI - 1) / TI;
  const int tiles = tiles_x * ((R + TI - 1) / TI);
  if (resident) {
    tile_live_kernel<<<tiles, 256, 0, st>>>(mask, tile_live, L, R, C, TI, tiles_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int launches = (K + S - 1) / S;
  // the last launch must land in `out`: start in `tmp` when launches is even
  const float* src = x0;
  float* dst = (launches % 2 == 0) ? tmp : out;
  for (int q = 0; q < launches; ++q) {
    const int sweeps = (K - q * S < S) ? K - q * S : S;
    float* plane_out = (q + 1 == launches) ? norm_plane : nullptr;
    if (resident) {
      const int v = src == x0 ? 0 : (src == tmp ? 1 : 2);
      rk<<<tiles < sms ? tiles : sms, cw * cw, smem, st>>>(maps[v], dst, plane_out, tile_live, R,
                                                           C, TI, S, sweeps, halo, tiles_x, tiles);
    } else {
      tiled_sweeps_kernel<<<dim3(tiles_x, (R + TI - 1) / TI), cw * cw, smem, st>>>(
          b, c_up, c_down, c_lat, mask, src, dst, plane_out, L, R, C, TI, S, sweeps, halo);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    dst = (dst == out) ? tmp : out;
  }
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int blocks = static_cast<int>((plane + kNormThreads - 1) / kNormThreads);
  plane_sum_kernel<<<blocks, kNormThreads, kNormThreads * sizeof(float), st>>>(
      norm_plane, plane, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, kSumThreads, kSumThreads * sizeof(float), st>>>(partial, blocks, norm);
  return static_cast<int>(cudaGetLastError());
}

// The per-sweep design: K launches of sweep_kernel, one thread per column
// in blocks of 256; `partial` holds ceil(R*C / 256) floats. Same buffers
// and return code as c3d_jacobi_bundle.
extern "C" int c3d_jacobi_bundle_per_sweep(const float* b, const float* c_up,
                                           const float* c_down, const float* c_lat,
                                           const float* mask, const float* x0,
                                           float* out, float* tmp, float* partial,
                                           float* norm, int L, int R, int C,
                                           int K, int halo, void* stream) {
  if (bad_box(L, R, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int blocks = static_cast<int>((plane + kNormThreads - 1) / kNormThreads);
  const size_t shmem = kNormThreads * sizeof(float);
  // the K-th sweep must land in `out`: start in `tmp` when K is even
  const float* src = x0;
  float* dst = (K % 2 == 0) ? tmp : out;
  for (int sweep = 1; sweep <= K; ++sweep) {
    if (sweep < K) {
      sweep_kernel<false><<<blocks, kNormThreads, 0, st>>>(
          b, c_up, c_down, c_lat, mask, src, dst, nullptr, L, R, C, halo);
    } else {
      sweep_kernel<true><<<blocks, kNormThreads, shmem, st>>>(
          b, c_up, c_down, c_lat, mask, src, dst, partial, L, R, C, halo);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    dst = (dst == out) ? tmp : out;
  }
  sum_kernel<<<1, kSumThreads, kSumThreads * sizeof(float), st>>>(partial, blocks, norm);
  return static_cast<int>(cudaGetLastError());
}
