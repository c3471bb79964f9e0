// K2: one diagonal tile's Cholesky factor L and its inverse V = inv(L).
//
// Replaces _chol_inv_kernel / pallas_cholesky_inv_tile in
// gogp_tpu/ops/cholesky_pallas.py, which factors a VMEM-resident tile in
// rank-32 panels and carries inv(L) along in the same substeps.
//
// What bounds it here: latency.  A 128 x 128 tile is 0.7 MFLOP for the
// factor and as much for the inverse, about a microsecond of one SM's
// arithmetic, but a factorization is a chain of dependent steps, each ending
// in a barrier or a round trip through shared memory.  The design keeps the
// whole problem in one block's shared memory (the working tile, which becomes
// L, and V: 2 x 128 x 129 floats, plus 12.5 KB of scratch) and works in
// 32-wide sub-panels, as the TPU kernel works in rank-32 panels.  Per
// sub-panel p (columns c = 32 p ...):
//
//   1. warp 0 factors the 32 x 32 diagonal block in registers, one lane per
//      row, with shuffles in place of barriers (the block has 512 threads,
//      so that a thread may hold a whole row without spilling); meanwhile
//      the other warps start block row p of V (inv_row_partial);
//   2. the 16 warps invert the diagonal block, a column at a time
//      (inv32_column);
//   3. the panel below becomes A_panel inv(L_cc)^T, a small product, and
//      block row p of V is finished (inv_row_finish);
//   4. all threads apply the rank-32 update to the trailing lower triangle.
//
// Five barriers per sub-panel, and every inner product runs as several
// independent chains.  The tile is read and written through leading
// dimensions, so the blocked driver factors the diagonal tile in place
// inside the n x n matrix and writes inv(L) straight into its stack of tile
// inverses.  A non-positive pivot gives NaN, as on the TPU; the front door's
// jitter loop sees it.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

// Cholesky of the 32 x 32 diagonal block of M at (c, c), in place, by one
// warp: lane l holds row c + l in registers.  dinv[c + s] gets 1 / L[c+s][c+s].
__device__ __forceinline__ void chol32(float* M, int ld, int c, float* dinv) {
  const int lane = threadIdx.x & 31;
  float* row = M + (c + lane) * ld + c;
  float a[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = row[k];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const float piv = __shfl_sync(gogp::kFullMask, a[s], s);
    const float rs = rsqrtf(piv);  // NaN for a non-positive pivot
    const float l = a[s] * rs;     // L[c + lane][c + s] on lanes below s
    if (lane == s) {
      a[s] = piv * rs;
      dinv[c + s] = rs;
    }
    if (lane > s) a[s] = l;
#pragma unroll
    for (int k = s + 1; k < 32; ++k) {
      const float lk = __shfl_sync(gogp::kFullMask, l, k);  // L[c + k][c + s]
      if (lane >= k) a[k] = fmaf(-l, lk, a[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k <= lane) row[k] = a[k];
}

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int B>
__global__ void __launch_bounds__(kThreads)
    chol_inv_tile_kernel(const float* a, int lda, float* l_out, int ldl,
                         float* __restrict__ v_out, int ldv) {
  constexpr int ld = gogp::kLd<B>;
  constexpr int RP = B > 32 ? (B - 32 + kWarps - 1) / kWarps : 1;  // panel rows per warp
  constexpr int NK = B > 32 ? B / 32 - 1 : 1;  // trailing column blocks, at most
  extern __shared__ float smem[];
  float* M = smem;                       // B x ld working tile; its lower triangle becomes L
  float* V = M + B * ld;                 // B x ld inverse
  float* T = V + B * ld;                 // (B/32 - 1) blocks for inv_row_partial
  float* dinv = T + (B / 32 - 1) * 1024; // B reciprocal pivots
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < B * B; idx += blockDim.x) M[(idx / B) * ld + idx % B] = a[(idx / B) * lda + idx % B];
  __syncthreads();  // a is read in full before l_out, which may alias it, is written

  for (int p = 0; p < B / 32; ++p) {
    const int c = 32 * p;
    if (warp == 0) chol32(M, ld, c, dinv);
    else if (p > 0) gogp::inv_row_partial<B>(M, V, T, p, warp - 1, kWarps - 1);
    __syncthreads();
    for (int j = warp; j < 32; j += kWarps) gogp::inv32_column(M, V, ld, c, j, dinv);
    __syncthreads();
    if (p > 0) gogp::inv_row_finish<B>(V, T, p, warp, kWarps);
    if (c + 32 == B) break;
    // Panel: P[r][s] = sum_t A[r][c + t] inv(L_cc)[s][t] for the rows r below
    // the block; warp w takes rows c + 32 + w + 16 m, lane l column s = l.
    // inv(L_cc) is zero above its diagonal, so every lane sums all 32 t.
    float pr[RP];
#pragma unroll
    for (int m = 0; m < RP; ++m) pr[m] = 0.0f;
    const float* vs = V + (c + lane) * ld + c;
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const float v = vs[t];
#pragma unroll
      for (int m = 0; m < RP; ++m) {
        const int r = c + 32 + warp + kWarps * m;
        if (r < B) pr[m] = fmaf(M[r * ld + c + t], v, pr[m]);
      }
    }
    __syncthreads();  // the panel is read in full before it is overwritten
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      const int r = c + 32 + warp + kWarps * m;
      if (r < B) M[r * ld + c + lane] = pr[m];
    }
    __syncthreads();
    // Trailing update of the lower triangle: M[i][k] -= P[i, :] . P[k, :],
    // lane l taking the columns k = c + 32 + l + 32 n of row i at once.
    const int nk = (B - c - 32) / 32;
    for (int i = c + 32 + warp; i < B; i += kWarps) {
      const float* pi = M + i * ld + c;
      float acc[NK];
#pragma unroll
      for (int n = 0; n < NK; ++n) acc[n] = 0.0f;
#pragma unroll 4
      for (int s = 0; s < 32; ++s) {
        const float ps = pi[s];
#pragma unroll
        for (int n = 0; n < NK; ++n)
          if (n < nk) acc[n] = fmaf(ps, M[(c + 32 + lane + 32 * n) * ld + c + s], acc[n]);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int k = c + 32 + lane + 32 * n;
        if (n < nk && k <= i) M[i * ld + k] -= acc[n];
      }
    }
    __syncthreads();
  }
  __syncthreads();

  for (int idx = tid; idx < B * B; idx += blockDim.x) {
    const int i = idx / B, k = idx % B;
    l_out[i * ldl + k] = (k <= i) ? M[i * ld + k] : 0.0f;
    v_out[i * ldv + k] = (k <= i) ? V[i * ld + k] : 0.0f;
  }
}

template <int B>
int launch(const float* a, int lda, float* l, int ldl, float* v, int ldv, cudaStream_t stream) {
  constexpr int smem = (2 * B * gogp::kLd<B> + gogp::kScratch<B>) * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(chol_inv_tile_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_tile_kernel<B><<<1, kThreads, smem, stream>>>(a, lda, l, ldl, v, ldv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles are row-major with leading dimensions lda, ldl, ldv (>= b); l may
// alias a, so a factor can be written in place over its input.
extern "C" int gogp_chol_inv_tile(const float* a, int lda, float* l, int ldl,
                                  float* v, int ldv, int b, cudaStream_t stream) {
  if (b != gogp::kTile || lda < b || ldl < b || ldv < b)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<gogp::kTile>(a, lda, l, ldl, v, ldv, stream);
}

extern "C" const char* gogp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
