// Device helpers shared by the tile kernels (chol_inv_tile.cu,
// tril_inv_tile.cu), the whole-matrix factorization (fused_chol.cu) and the
// streaming solves (trsv.cu).
//
// Tiles are B x B in shared memory, row-major, with a padded leading
// dimension B + 1: a warp that reads one COLUMN (32 rows at a
// fixed column) then hits 32 different banks, as does a warp reading a row.
// The tile functions run on blocks of 16 or 32 warps; the 32 x 32 sub-blocks
// of a tile are the unit of work, a row or a column of one per warp.
#pragma once

#include <cuda_runtime.h>

namespace gogp {

// Most dynamic shared memory one block may use on Hopper (227 KB).
constexpr int kMaxSharedBytes = 232448;
// The one tile size K2 and K5 are built for (DEFAULT_BLOCK in
// gogp_torch/ops/cholesky_blocked.py): a tile and its inverse fit one
// block's shared memory.  The helpers below are written for any multiple of
// 32.
constexpr int kTile = 128;
constexpr unsigned kFullMask = 0xffffffffu;

template <int B>
constexpr int kLd = B + 1;

// Scratch floats the tile kernels need beside the two tiles: the T blocks of
// inv_row_partial, and the reciprocal diagonal of L.
template <int B>
constexpr int kScratch = (B / 32 - 1) * 32 * 32 + B;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Column j of inv(L_cc), L_cc the 32 x 32 lower-triangular block of L at
// (c, c), written into V's block at (c, c); run by one whole warp, lane l
// owning row c + l.  dinv[c + i] holds 1 / L[c + i][c + i].  Row by row, a
// shuffle broadcasts the solved entry and every lane below subtracts its
// multiple: no barrier, no shared traffic for the solution.  Rows above j
// stay zero.
__device__ __forceinline__ void inv32_column(const float* __restrict__ L,
                                             float* __restrict__ V, int ld, int c,
                                             int j, const float* __restrict__ dinv) {
  const int lane = threadIdx.x & 31;
  const float* row = L + (c + lane) * ld + c;
  float x = (lane == j) ? 1.0f : 0.0f;
  for (int i = j; i < 32; ++i) {
    const float xi = __shfl_sync(kFullMask, x, i) * dinv[c + i];
    if (lane == i) x = xi;
    if (lane > i) x = fmaf(-row[i], xi, x);
  }
  V[(c + lane) * ld + c + j] = x;
}

// The blocks of V = inv(L) left of the diagonal in block row p follow from
// the block rows above it:
//
//   T_q  = sum_{k=q}^{p-1} L_pk V_kq,      V_pq = -V_pp T_q     (q < p)
//
// inv_row_partial computes the T_q (it needs V's block rows < p, not V_pp);
// inv_row_finish applies V_pp.  Each covers rows r0, r0 + rstep, ... of the
// block row; lane l takes column l of every block, so reads of L and of V_pp
// are warp broadcasts and reads of V_kq and T are consecutive.  The q < p
// sums run as independent chains.  T holds (B/32 - 1) 32 x 32 blocks.
template <int B>
__device__ __forceinline__ void inv_row_partial(const float* __restrict__ L,
                                                const float* __restrict__ V,
                                                float* __restrict__ T, int p, int r0,
                                                int rstep) {
  constexpr int ld = kLd<B>;
  constexpr int Q = B / 32 > 1 ? B / 32 - 1 : 1;
  const int col = threadIdx.x & 31, cp = 32 * p;
  for (int r = r0; r < 32; r += rstep) {
    const float* lrow = L + (cp + r) * ld;
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < cp; ++k) {
      const float lk = lrow[k];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (32 * q <= k) acc[q] = fmaf(lk, V[k * ld + 32 * q + col], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (q < p) T[(q * 32 + r) * 32 + col] = acc[q];
  }
}

template <int B>
__device__ __forceinline__ void inv_row_finish(float* __restrict__ V,
                                               const float* __restrict__ T, int p,
                                               int r0, int rstep) {
  constexpr int ld = kLd<B>;
  constexpr int Q = B / 32 > 1 ? B / 32 - 1 : 1;
  const int col = threadIdx.x & 31, cp = 32 * p;
  for (int r = r0; r < 32; r += rstep) {
    const float* vrow = V + (cp + r) * ld + cp;
    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
#pragma unroll 8
    for (int s = 0; s < 32; ++s) {
      const float v = vrow[s];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (q < p) acc[q] = fmaf(v, T[(q * 32 + s) * 32 + col], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (q < p) V[(cp + r) * ld + 32 * q + col] = -acc[q];
  }
}

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
    const float piv = __shfl_sync(kFullMask, a[s], s);
    const float rs = rsqrtf(piv);  // NaN for a non-positive pivot
    const float l = a[s] * rs;     // L[c + lane][c + s] on lanes below s
    if (lane == s) {
      a[s] = piv * rs;
      dinv[c + s] = rs;
    }
    if (lane > s) a[s] = l;
#pragma unroll
    for (int k = s + 1; k < 32; ++k) {
      const float lk = __shfl_sync(kFullMask, l, k);  // L[c + k][c + s]
      if (lane >= k) a[k] = fmaf(-l, lk, a[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k <= lane) row[k] = a[k];
}

// The block size chol_inv_tile_body is written for.
constexpr int kTileThreads = 512;

// Shared memory chol_inv_tile_body needs: the working tile, its inverse and
// the scratch, in floats.
template <int B>
constexpr int kTileSmemFloats = 2 * B * kLd<B> + kScratch<B>;

// One B x B SPD tile's Cholesky factor L and its inverse V = inv(L), by one
// block of kTileThreads threads with kTileSmemFloats<B> floats of shared
// memory at smem (the body of K2, shared with K1).  Tiles are row-major with
// leading dimensions lda, ldl, ldv; l_out may alias a.  a is read through
// L2 (ld.global.cg), never through L1 or the read-only path, so the tile may
// have been written by other blocks of the same launch before a grid-wide
// barrier.  A non-positive pivot gives NaN; the body never returns early.
//
// Per 32-wide sub-panel p (columns c = 32 p ...):
//   1. warp 0 factors the 32 x 32 diagonal block in registers (chol32);
//      meanwhile the other warps start block row p of V (inv_row_partial);
//   2. the 16 warps invert the diagonal block, a column at a time
//      (inv32_column);
//   3. the panel below becomes A_panel inv(L_cc)^T and block row p of V is
//      finished (inv_row_finish);
//   4. all threads apply the rank-32 update to the trailing lower triangle.
template <int B>
__device__ __forceinline__ void chol_inv_tile_body(const float* a, int lda, float* l_out,
                                                   int ldl, float* v_out, int ldv,
                                                   float* smem) {
  constexpr int kWarps = kTileThreads / 32;
  constexpr int ld = kLd<B>;
  constexpr int RP = B > 32 ? (B - 32 + kWarps - 1) / kWarps : 1;  // panel rows per warp
  constexpr int NK = B > 32 ? B / 32 - 1 : 1;  // trailing column blocks, at most
  float* M = smem;                       // B x ld working tile; its lower triangle becomes L
  float* V = M + B * ld;                 // B x ld inverse
  float* T = V + B * ld;                 // (B/32 - 1) blocks for inv_row_partial
  float* dinv = T + (B / 32 - 1) * 1024; // B reciprocal pivots
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < B * B; idx += kTileThreads)
    M[(idx / B) * ld + idx % B] = __ldcg(a + (idx / B) * lda + idx % B);
  __syncthreads();  // a is read in full before l_out, which may alias it, is written

  for (int p = 0; p < B / 32; ++p) {
    const int c = 32 * p;
    if (warp == 0) chol32(M, ld, c, dinv);
    else if (p > 0) inv_row_partial<B>(M, V, T, p, warp - 1, kWarps - 1);
    __syncthreads();
    for (int j = warp; j < 32; j += kWarps) inv32_column(M, V, ld, c, j, dinv);
    __syncthreads();
    if (p > 0) inv_row_finish<B>(V, T, p, warp, kWarps);
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

  for (int idx = tid; idx < B * B; idx += kTileThreads) {
    const int i = idx / B, k = idx % B;
    l_out[i * ldl + k] = (k <= i) ? M[i * ld + k] : 0.0f;
    v_out[i * ldv + k] = (k <= i) ? V[i * ld + k] : 0.0f;
  }
}

}  // namespace gogp
