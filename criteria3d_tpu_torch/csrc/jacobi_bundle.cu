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
//   sum |x - x_prev| * (|x| > 1 ? 1/|x| : 1) * mask.
// Every array is float32, (L, R, C) row-major; c_lat is (8, L, R, C).
//
// Numerics: each term is added in the order above with a separate multiply
// and add. The library is built with --fmad=false so that nvcc does not
// contract them into FMAs: x then equals the plain PyTorch version
// (solver/jacobi_bundle.py:jacobi_bundle_reference) bit for bit. Neighbour
// reads outside the box are guarded and contribute 0, which is what the
// TPU kernel's wrap-around reads give, since the assembly zeroes c_up[0],
// c_down[L-1] and every lateral coefficient whose neighbour is missing.
// The norm is reduced without atomics, in a fixed order, so it is the same
// from run to run.
//
// Bound: device memory. A bundle must read 13 arrays (b, c_up, c_down, mask,
// x, 8 x c_lat) and write x once: 14 x L*R*C x 4 bytes, about 231 MB at the
// 7 x 768 x 768 catchment box, 69 us at 3.35 TB/s; its ~21 flops per node
// and sweep are far below the float32 rate. This design is the simple one:
// one launch per sweep, ping-ponging x between two buffers, so it moves K
// times those bytes (K = 8) and runs at best at 1/K of the bound. One thread
// owns one (r, c) column and walks its L layers, keeping x[l-1], x[l],
// x[l+1] of its column in registers; threads of a warp take neighbouring c,
// so every array read is coalesced, and the lateral x reads hit L1/L2.
// Keeping the coefficients on chip across the K sweeps (temporal blocking
// with halos, staged by cp.async or TMA) is the step to the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLateral = 8;
__constant__ int kDr[kLateral] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDc[kLateral] = {0, 0, -1, 1, -1, 1, -1, 1};

// Sum of blockDim.x values in shared memory, in a fixed tree order; the
// result lands in red[0]. blockDim.x must be a power of two.
__device__ void block_sum(float* red) {
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + s];
    __syncthreads();
  }
}

template <bool kLast>
__global__ void sweep_kernel(const float* __restrict__ b,
                             const float* __restrict__ c_up,
                             const float* __restrict__ c_down,
                             const float* __restrict__ c_lat,
                             const float* __restrict__ mask,
                             const float* __restrict__ x,
                             float* __restrict__ y,
                             float* __restrict__ partial,
                             int L, int R, int C) {
  extern __shared__ float red[];
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int64_t box = plane * L;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float local = 0.0f;
  if (col < plane) {
    const int r = static_cast<int>(col / C);
    const int c = static_cast<int>(col - static_cast<int64_t>(r) * C);
    int64_t nb_off[kLateral];
    bool nb_ok[kLateral];
#pragma unroll
    for (int k = 0; k < kLateral; ++k) {
      const int rr = r + kDr[k];
      const int cc = c + kDc[k];
      nb_ok[k] = rr >= 0 && rr < R && cc >= 0 && cc < C;
      nb_off[k] = static_cast<int64_t>(kDr[k]) * C + kDc[k];
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
      if (kLast) {
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

constexpr int kSumThreads = 1024;

}  // namespace

// K sweeps from x0; the result goes to `out`, `tmp` is the second ping-pong
// buffer (both L*R*C floats), `partial` holds ceil(R*C / threads) floats and
// `norm` one float. `threads` must be a power of two <= 1024. Launches on
// `stream` and does not synchronise; returns the CUDA error code (0 = ok).
extern "C" int c3d_jacobi_bundle(const float* b, const float* c_up,
                                 const float* c_down, const float* c_lat,
                                 const float* mask, const float* x0,
                                 float* out, float* tmp, float* partial,
                                 float* norm, int L, int R, int C, int K,
                                 int threads, void* stream) {
  if (L < 1 || R < 1 || C < 1 || K < 1 || threads < 32 || threads > 1024 ||
      (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(R) * C;
  const int blocks = static_cast<int>((plane + threads - 1) / threads);
  const size_t shmem = static_cast<size_t>(threads) * sizeof(float);
  // the K-th sweep must land in `out`: start in `tmp` when K is even
  const float* src = x0;
  float* dst = (K % 2 == 0) ? tmp : out;
  for (int sweep = 1; sweep <= K; ++sweep) {
    if (sweep < K) {
      sweep_kernel<false><<<blocks, threads, 0, s>>>(
          b, c_up, c_down, c_lat, mask, src, dst, nullptr, L, R, C);
    } else {
      sweep_kernel<true><<<blocks, threads, shmem, s>>>(
          b, c_up, c_down, c_lat, mask, src, dst, partial, L, R, C);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    dst = (dst == out) ? tmp : out;
  }
  sum_kernel<<<1, kSumThreads, kSumThreads * sizeof(float), s>>>(partial, blocks, norm);
  return static_cast<int>(cudaGetLastError());
}
