// Device helpers shared by the tile kernels (chol_inv_tile.cu,
// tril_inv_tile.cu) and the streaming solves (trsv.cu).
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

}  // namespace gogp
