// K7: the batch of L^-1 for a batch of small SPD covariances, K = L L^T.
//
// Replaces the inner `kernel` / `pallas_linv` of make_fused_value_and_grad in
// gogp_tpu/ops/fused_gp.py: there a masked-reduction Cholesky (chol_value)
// and Gauss-Jordan on [L | I] (lower_inv_value), run over a grid of ~1 MB
// chunks of the chain batch.  The sampler calls it once per leapfrog step
// for the whole chain population; the LML, W = alpha alpha^T - K^-1 and the
// gradient stay outside the kernel, as they stay in XLA on the TPU.
//
// What bounds it here: latency.  At the hyperpriors shapes (64 chains,
// n = 44) the whole batch is 0.5 MB in and out and 1.6 MFLOP, microseconds
// of the card's bandwidth or FMA rate; what costs is the chain of dependent
// steps inside one matrix (n pivots) and every barrier on it.  Two size
// classes, chosen here from n:
//
//   n <= 64: one WARP per matrix, the matrix in REGISTERS, no block barrier.
//   Lane l owns rows l and l + 32, each a register array of NP = 32, 48 or
//   64 columns (the class n falls in, padded with the identity), and the whole
//   elimination is unrolled, so every index is static.  Cholesky and the
//   inverse are ONE symmetric Gauss-Jordan sweep without square roots, K =
//   Lu D Lu^T: at pivot j the owner of row j puts the row into the warp's
//   shared buffer as [Yu[j][0..j-1] | 1 | S[j][j+1..]] (its row of inv(Lu) so
//   far, then the Schur complement's row, which by symmetry is its column),
//   and every row i > j takes a_i[c] -= (S[i][j] / S[j][j]) r[c] over all
//   columns: for c > j the trailing update, for c <= j the forward
//   elimination of the identity.  Row j of L^-1 is then Yu[j][.] / sqrt(D_j),
//   scaled once when the row is written.  Per pivot: NP/4 16-byte stores by
//   one lane, one __syncwarp() (the buffer is double), NP/4 broadcast loads
//   and 2 NP independent FMAs a lane; no lane runs a dependent chain alone.
//   Two variants lost to this one on an H100: the matrix in the warp's
//   shared memory, updated in place as float4 (every FMA waits for a
//   shared-memory round trip), and the pivots in a loop, with the pivot
//   column read back from the buffer and selected into place.
//   A CTA holds 1, 2, 4 or 8 warps, the fewest that keep the grid within one
//   wave of the card's SMs, the last CTA ragged.
//
//   64 < n <= 128: one CTA of 512 threads per matrix, blocked.  The matrix
//   is padded with the identity to 96 or 128 and factored by K2's body
//   (tile_common.cuh, chol_inv_tile_factor): block columns of 32, a warp
//   factors and inverts the 32 x 32 diagonal block in registers while the
//   other warps apply the previous panel's update beyond it (look-ahead),
//   the panel below is multiplied by that block's inverse, and L^-1 follows
//   block row by block row, all products as register tiles.  Four block
//   barriers per block column, 3 or 4 of them.  The padding factors to
//   itself and costs no accuracy.  This kernel reads L^-1 and 1 / diag(L)
//   from the body's shared memory (kTileV, kTileDinv).
//
// A non-positive or NaN pivot gives NaN throughout that matrix's L^-1 and
// never an early return; other matrices of the batch are untouched.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "tile_common.cuh"

namespace {

constexpr int kSmallMaxN = 64;  // one warp per matrix up to here
constexpr int kMaxN = 128;
constexpr int kMaxWarps = 8;    // warps, so matrices, per CTA in the small class

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

// NP: the padded size, a multiple of 4; rows lane (and lane + 32 if NP > 32).
// vec: n is a multiple of 4 and both pointers are 16-byte aligned, so rows
// move as float4.
template <int NP>
__global__ void __launch_bounds__(32 * kMaxWarps)
    linv_warp_kernel(const float* __restrict__ k, float* __restrict__ linv, int batch, int n, bool vec) {
  constexpr int R = NP > 32 ? 2 : 1;  // rows a lane owns
  constexpr int Q = NP / 4;
  __shared__ __align__(16) float rbuf[kMaxWarps][2][NP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mat = blockIdx.x * (blockDim.x >> 5) + warp;
  if (mat >= batch) return;  // a whole warp of the ragged last CTA; no block barrier below
  const float* src = k + static_cast<size_t>(mat) * n * n;
  float* dst = linv + static_cast<size_t>(mat) * n * n;

  float a[R][NP];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = lane + 32 * t;
    if (vec) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < n && 4 * q < n) v = reinterpret_cast<const float4*>(src + i * n)[q];
        a[t][4 * q] = v.x;
        a[t][4 * q + 1] = v.y;
        a[t][4 * q + 2] = v.z;
        a[t][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NP; ++c) a[t][c] = (i < n && c < n) ? src[i * n + c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < NP; ++c)
      if (i >= n && c == i) a[t][c] = 1.0f;  // the identity beyond n
  }

  bool bad = false;
  float rs_own[R];  // 1 / sqrt(D_i) of the rows this lane owns
#pragma unroll
  for (int t = 0; t < R; ++t) rs_own[t] = 1.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j < n) {  // the same for the whole warp; the padding's pivots change nothing
      const int tj = j >> 5, owner = j & 31;
      float* rb = rbuf[warp][j & 1];
      if (lane == owner) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          reinterpret_cast<float4*>(rb)[q] =
              make_float4(4 * q == j ? 1.0f : a[tj][4 * q], 4 * q + 1 == j ? 1.0f : a[tj][4 * q + 1],
                          4 * q + 2 == j ? 1.0f : a[tj][4 * q + 2], 4 * q + 3 == j ? 1.0f : a[tj][4 * q + 3]);
      }
      const float piv = __shfl_sync(gogp::kFullMask, a[tj][j], owner);
      __syncwarp();
      const bool ok = piv > 0.0f;
      bad |= !ok;
      const float ip = ok ? __frcp_rn(piv) : quiet_nan();
      const float rs = ok ? rsqrtf(piv) : quiet_nan();
      float m[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + 32 * t;
        if (i == j) rs_own[t] = rs;
        m[t] = i > j ? -a[t][j] * ip : 0.0f;
        if (i > j) a[t][j] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 r = reinterpret_cast<const float4*>(rb)[q];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          a[t][4 * q] = fmaf(m[t], r.x, a[t][4 * q]);
          a[t][4 * q + 1] = fmaf(m[t], r.y, a[t][4 * q + 1]);
          a[t][4 * q + 2] = fmaf(m[t], r.z, a[t][4 * q + 2]);
          a[t][4 * q + 3] = fmaf(m[t], r.w, a[t][4 * q + 3]);
        }
      }
    }
  }

  // Row i of L^-1: Yu[i][c] / sqrt(D_i) left of the diagonal, 1 / sqrt(D_i) on it.
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = lane + 32 * t;
    if (i < n) {
      float o[NP];
#pragma unroll
      for (int c = 0; c < NP; ++c)
        o[c] = bad ? quiet_nan() : (c < i ? a[t][c] * rs_own[t] : (c == i ? rs_own[t] : 0.0f));
      if (vec) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (4 * q < n)
            reinterpret_cast<float4*>(dst + i * n)[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < NP; ++c)
          if (c < n) dst[i * n + c] = o[c];
      }
    }
  }
}

template <int B>
__global__ void __launch_bounds__(gogp::kTileThreads)
    linv_block_kernel(const float* __restrict__ k, float* __restrict__ linv, int n) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = gogp::kTileLd<B>;
  constexpr int kWarps = gogp::kTileThreads / 32;
  float* M = smem;                                  // K padded with the identity; becomes L
  const float* V = smem + gogp::kTileV<B>;          // L^-1
  const float* dinv = smem + gogp::kTileDinv<B>;    // 1 / diag(L), as the factor leaves it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = k + static_cast<size_t>(blockIdx.x) * n * n;
  float* dst = linv + static_cast<size_t>(blockIdx.x) * n * n;

  for (int i = warp; i < B; i += kWarps)
    for (int c = lane; c < B; c += 32)
      M[i * ld + c] = (i < n && c < n) ? src[i * n + c] : (i == c ? 1.0f : 0.0f);
  __syncthreads();

  gogp::chol_inv_tile_factor<B, true>(smem);

  // A pivot that was not positive left a reciprocal that is not a positive
  // finite number.
  int bad = 0;
  for (int i = tid; i < n; i += gogp::kTileThreads) bad |= !(dinv[i] > 0.0f && dinv[i] <= FLT_MAX);
  bad = __syncthreads_or(bad);
  for (int i = warp; i < n; i += kWarps)
    for (int c = lane; c < n; c += 32)
      dst[i * n + c] = bad ? quiet_nan() : (c <= i ? V[i * ld + c] : 0.0f);
}

template <int B>
cudaError_t launch_block(const float* k, float* linv, int batch, int n, cudaStream_t stream) {
  constexpr int smem = gogp::kTileSmemFloats<B> * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "the padded matrix and its inverse must fit one block");
  cudaError_t err = cudaFuncSetAttribute(linv_block_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  linv_block_kernel<B><<<batch, gogp::kTileThreads, smem, stream>>>(k, linv, n);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_warp(const float* k, float* linv, int batch, int n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int warps = 1;
  while (warps < kMaxWarps && (batch + warps - 1) / warps > sms) warps *= 2;
  const dim3 grid((batch + warps - 1) / warps), block(32 * warps);
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(linv)) % 16 == 0;
  linv_warp_kernel<NP><<<grid, block, 0, stream>>>(k, linv, batch, n, vec);
  return cudaGetLastError();
}

}  // namespace

// k and linv: `batch` row-major n x n matrices, contiguous; 1 <= n <= 128.
extern "C" int gogp_fused_gp_linv(const float* k, float* linv, int batch, int n,
                                  cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 32) return static_cast<int>(launch_warp<32>(k, linv, batch, n, stream));
  if (n <= 48) return static_cast<int>(launch_warp<48>(k, linv, batch, n, stream));
  if (n <= kSmallMaxN) return static_cast<int>(launch_warp<64>(k, linv, batch, n, stream));
  if (n <= 96) return static_cast<int>(launch_block<96>(k, linv, batch, n, stream));
  return static_cast<int>(launch_block<128>(k, linv, batch, n, stream));
}
