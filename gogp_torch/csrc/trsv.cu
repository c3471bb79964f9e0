// K3: streaming triangular vector solves with a blocked factor,
//   z = L^{-1} y      (gogp_trsv_lower)
//   x = L^{-T} z      (gogp_trsv_lower_t)
// with the diagonal tiles applied through their precomputed inverses
// invs[k] = inv(L[kb:(k+1)b, kb:(k+1)b]), the by-product of K2.
//
// Replaces _trsv_kernel / pallas_trsv_lower and _trsv_t_kernel /
// pallas_trsv_lower_t in gogp_tpu/ops/cholesky_pallas.py.  Those run a
// sequential grid over block rows that carries the solved prefix from one
// step to the next in VMEM scratch.  Blocks of a CUDA grid run in no order
// and share nothing, so here ONE block loops over the block rows and keeps the
// whole solution vector in shared memory (n floats: 16 KB at n = 4096).
//
// What bounds it here: bytes.  Each solve reads the lower triangle of L once,
// n*n/2 floats (32 MB at n = 4096) against 2*n*n/2 FLOPs, and one SM cannot
// pull more than a fraction of the card's bandwidth.  The design keeps every
// read of L coalesced and many reads in flight: the forward solve reads rows
// of L[c0:c1, :c0] as float4, one warp per row, eight independent sums per
// lane, and a warp reduction; the transpose solve reads the column panel
// L[c1:, c0:c1], b contiguous floats in each row, as float4 with the rows
// split among thread groups whose partial sums meet in shared memory.  The
// diagonal tile's inverse is applied the same way.  Spreading the solve over
// many SMs is later work.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void axpy4(float4& s, float4 a, float x) {
  s.x = fmaf(a.x, x, s.x);
  s.y = fmaf(a.y, x, s.y);
  s.z = fmaf(a.z, x, s.z);
  s.w = fmaf(a.w, x, s.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 u, float s) {
  s = fmaf(a.x, u.x, s);
  s = fmaf(a.y, u.y, s);
  s = fmaf(a.z, u.z, s);
  return fmaf(a.w, u.w, s);
}

__global__ void __launch_bounds__(kThreads)
    trsv_lower_kernel(const float* __restrict__ L, const float* __restrict__ y,
                      const float* __restrict__ invs, float* __restrict__ x_out,
                      int n, int b) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;       // n: the solution, filled block row by block row
  float* resid = x + n;  // b: right-hand side of the current diagonal tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  for (int c0 = 0; c0 < n; c0 += b) {
    // resid[r] = y[c0 + r] - L[c0 + r, :c0] . x[:c0]
    for (int r = warp; r < b; r += nwarps) {
      const float4* row = reinterpret_cast<const float4*>(L + static_cast<size_t>(c0 + r) * n);
      // eight independent chains keep eight 16-byte loads per lane in flight
      float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      const int end = c0 / 4;
      int c = lane;
      for (; c + 7 * 32 < end; c += 8 * 32) {
#pragma unroll
        for (int u = 0; u < 8; ++u) s[u] = dot4(row[c + 32 * u], x4[c + 32 * u], s[u]);
      }
      for (; c < end; c += 32) s[0] = dot4(row[c], x4[c], s[0]);
      const float sum = gogp::warp_sum(((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7])));
      if (lane == 0) resid[r] = y[c0 + r] - sum;
    }
    __syncthreads();
    // x[c0 + r] = inv_k[r, :] . resid
    const float* inv = invs + static_cast<size_t>(c0) * b;
    for (int r = warp; r < b; r += nwarps) {
      float s = 0.0f;
      for (int c = lane; c < b; c += 32) s = fmaf(inv[r * b + c], resid[c], s);
      s = gogp::warp_sum(s);
      if (lane == 0) x[c0 + r] = s;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) x_out[i] = x[i];
}

__global__ void __launch_bounds__(kThreads)
    trsv_lower_t_kernel(const float* __restrict__ L, const float* __restrict__ z,
                        const float* __restrict__ invs, float* __restrict__ x_out,
                        int n, int b) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;           // n: the solution, filled bottom-up
  float* resid = x + n;      // b
  float* part = resid + b;   // 4 * blockDim.x partial sums
  // Panel reads: thread (g4, r4) takes columns 4 r4 .. 4 r4 + 3 of rows
  // g4, g4 + groups4, ... as one float4.
  const int r4 = threadIdx.x % (b / 4), g4 = threadIdx.x / (b / 4);
  const int groups4 = blockDim.x / (b / 4);
  // Tile-inverse reads: thread (g, r) takes column r of rows g, g + groups, ...
  const int r = threadIdx.x % b, g = threadIdx.x / b;
  const int groups = blockDim.x / b;

  for (int c0 = n - b; c0 >= 0; c0 -= b) {
    const int c1 = c0 + b;
    // resid[r] = z[c0 + r] - L[c1:, c0 + r] . x[c1:]
    const float* col = L + c0 + 4 * r4;
    float4 s0 = {0.0f, 0.0f, 0.0f, 0.0f}, s1 = s0, s2 = s0, s3 = s0;
    int i = c1 + g4;
    for (; i + 3 * groups4 < n; i += 4 * groups4) {
      axpy4(s0, *reinterpret_cast<const float4*>(col + static_cast<size_t>(i) * n), x[i]);
      axpy4(s1, *reinterpret_cast<const float4*>(col + static_cast<size_t>(i + groups4) * n), x[i + groups4]);
      axpy4(s2, *reinterpret_cast<const float4*>(col + static_cast<size_t>(i + 2 * groups4) * n), x[i + 2 * groups4]);
      axpy4(s3, *reinterpret_cast<const float4*>(col + static_cast<size_t>(i + 3 * groups4) * n), x[i + 3 * groups4]);
    }
    for (; i < n; i += groups4)
      axpy4(s0, *reinterpret_cast<const float4*>(col + static_cast<size_t>(i) * n), x[i]);
    float4 sum;
    sum.x = (s0.x + s1.x) + (s2.x + s3.x);
    sum.y = (s0.y + s1.y) + (s2.y + s3.y);
    sum.z = (s0.z + s1.z) + (s2.z + s3.z);
    sum.w = (s0.w + s1.w) + (s2.w + s3.w);
    *reinterpret_cast<float4*>(part + g4 * b + 4 * r4) = sum;
    __syncthreads();
    if (threadIdx.x < b) {
      float t = 0.0f;
      for (int q = 0; q < groups4; ++q) t += part[q * b + threadIdx.x];
      resid[threadIdx.x] = z[c0 + threadIdx.x] - t;
    }
    __syncthreads();
    // x[c0 + r] = inv_k[:, r] . resid (inv_k^T applied), split over the
    // groups so that reads of inv_k rows stay coalesced
    const float* inv = invs + static_cast<size_t>(c0) * b;
    float t = 0.0f;
    for (int q = g; q < b; q += groups) t = fmaf(inv[q * b + r], resid[q], t);
    part[threadIdx.x] = t;  // part[] was last read before the barrier above
    __syncthreads();
    if (threadIdx.x < b) {
      float u = 0.0f;
      for (int q = 0; q < groups; ++q) u += part[q * b + threadIdx.x];
      x[c0 + threadIdx.x] = u;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) x_out[i] = x[i];
}

int launch(bool transpose, const float* L, const float* y, const float* invs,
           float* x, int n, int b, cudaStream_t stream) {
  if (b < 32 || b % 32 != 0 || kThreads % b != 0 || n % b != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (n + b + 4 * kThreads) * static_cast<int>(sizeof(float));
  if (smem > gogp::kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = transpose ? trsv_lower_t_kernel : trsv_lower_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, stream>>>(L, y, invs, x, n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gogp_trsv_lower(const float* L, const float* y, const float* invs,
                               float* x, int n, int b, cudaStream_t stream) {
  return launch(false, L, y, invs, x, n, b, stream);
}

extern "C" int gogp_trsv_lower_t(const float* L, const float* z, const float* invs,
                                 float* x, int n, int b, cudaStream_t stream) {
  return launch(true, L, z, invs, x, n, b, stream);
}
