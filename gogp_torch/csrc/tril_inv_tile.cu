// K5: inverse of a stack of lower-triangular tiles, V[t] = inv(L[t]).
//
// Replaces _tril_inv_kernel / pallas_tril_inv_tile in
// gogp_tpu/ops/cholesky_pallas.py (rank-8 forward substitution of one
// VMEM-resident tile), and _tile_invs, which vmaps it over the (nb, b, b)
// diagonal tiles: here the whole stack is one launch.
//
// What bounds it here: one SM's latency.  inv(L) of a 128-tile is 0.7 MFLOP
// on 64 KB, a few microseconds of one SM if every lane were busy; the paths
// invert only 12 to 128 tiles, so the time is the chain of one tile.
//
// Accuracy sets the chain.  Forming the blocks below the diagonal from
// products of inverses (inv([A 0; C D]) = [inv(A) 0; -inv(D) C inv(A)
// inv(D)], depth 2 over 32-blocks) is short, but multiplying by a computed
// inv(D) carries its error: on GP covariance tiles with a diagonal from 1e-3
// to 1 it was 1e2-1e3 times less accurate than forward substitution
// (PERF.md).  Substitution against L's own diagonal blocks keeps the error of
// forward substitution, so the chain is four 32-row solves:
//
//   V_pq = inv(L_pp) (delta_pq I - sum_{k=q}^{p-1} L_pk V_kq),  p = 0..3,
//
// block row by block row, every block column q <= p at once:
//
//   - the products L_pk V_kq of block row p, one 32 x 32 x 32 product per
//     pair (q, k), two warps each, 4 x 4 outputs a thread (mma_rows of the
//     tile body in tile_common.cuh), each into its own scratch block in L's
//     unused upper triangle, then summed for each block column in k order
//     (one more barrier: the solves' inner loops stay as in the tile body);
//   - warp q solves L_pp X = -sum_k L_pk V_kq (the identity for q = p) by
//     substitution, lane = column, 8 rows at a time (diag_solve_column, the
//     tile body's diagonal inverse), with reciprocal pivots from one more
//     warp;
//   - the tile is copied into shared memory (rows padded to B + 4 floats,
//     kTileLd) by cp.async, every copy in flight at once, one commit group
//     per block row, and step p waits only for block rows up to p; block row
//     p of V is written to device memory, zeros above the diagonal, by the
//     12 idle warps during step p + 1's solves.
//
// Where a stack has fewer tiles than the card has SMs, a tile may be split
// over `split` CTAs (1, 2 or 4) by block column: block column q of inv(L)
// needs only L's rows and columns from 32 q on and no other block column, so
// each CTA solves its own.  gogp_tril_inv_tiles takes the split that
// chip_smoke.py measured fastest at the stack's count (kSplit4MaxCount).
//
// A NaN in L flows into V (1 / 0 gives inf, and 0 * inf NaN); no CTA returns
// early.  Built with -DGOGP_TILE_STAMPS, thread 0 records clock64() at each
// stage, as the tile body's does (gogp_tril_inv_tiles_stamps; one tile).
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr int B = gogp::kTile;
constexpr int NB = B / 32;  // diagonal blocks of a tile
constexpr int kThreads = 512;
constexpr int ld = gogp::kTileLd<B>;
constexpr int Q = B / 4;                      // float4 of a row
constexpr int kLoads = B * Q / kThreads;      // 16-byte copies a thread
constexpr int kDinvWarp = kThreads / 32 - 1;  // the warp that forms 1 / L_ii
constexpr int kSmemBytes = (2 * B * ld + B) * static_cast<int>(sizeof(float));
static_assert(B == 128 && kLoads == 2 * NB, "two loads a thread for each block row");
static_assert(kSmemBytes <= gogp::kMaxSharedBytes, "tile does not fit shared memory");

// 16 bytes from device to shared memory, asynchronously, through L2.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// The scratch block of the product L_pk V_kq (q <= k < p): L's block (q, k + 1),
// above the diagonal, which is never loaded.
__device__ __forceinline__ float* scratch(float* L, int q, int k) { return L + 32 * q * ld + 32 * (k + 1); }

// Rows [32 p, 32 p + 32) of V, columns [c0, c1), to v (row-major, B wide),
// zeros above the diagonal, by threads first .. first + count - 1.
__device__ __forceinline__ void store_rows(float* v, const float* V, int p, int c0, int c1, int first, int count) {
  for (int q = threadIdx.x - first; q < 32 * Q; q += count) {
    const int i = 32 * p + q / Q, k = 4 * (q % Q);
    if (k < c0 || k >= c1) continue;
    const float4 m = gogp::ld4(V + i * ld + k);
    *reinterpret_cast<float4*>(v + i * B + k) =
        make_float4(k <= i ? m.x : 0.0f, k + 1 <= i ? m.y : 0.0f, k + 2 <= i ? m.z : 0.0f, k + 3 <= i ? m.w : 0.0f);
  }
}

// Grid (count, split): CTA (t, y) writes block columns [q0, q1) of inv(L[t]).
// vec: l and v are 16-byte aligned (else scalar copies, all at the ends).
__global__ void __launch_bounds__(kThreads)
    tril_inv_tiles_kernel(const float* __restrict__ l, float* __restrict__ v, int split, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* L = smem;
  float* V = L + B * ld;
  float* dinv = V + B * ld;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = NB * static_cast<int>(blockIdx.y) / split, q1 = NB * (static_cast<int>(blockIdx.y) + 1) / split;
  const int c0 = 32 * q0, c1 = 32 * q1;
  l += static_cast<size_t>(blockIdx.x) * B * B;
  v += static_cast<size_t>(blockIdx.x) * B * B;
  GOGP_STAMP(kStampStart, 0);

  // Copy it of a thread is row tid / Q + (kThreads / Q) it, so copies 2p
  // and 2p + 1 are its share of block row p, one commit group.  Only rows and
  // columns from c0 on, up to the end of the row's diagonal block, are read.
  const auto needed = [&](int i, int k) { return i >= c0 && k >= c0 && k < (i | 31) + 1; };
  if (vec) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int q = tid + it * kThreads, i = q / Q, k = 4 * (q % Q);
      if (needed(i, k)) cp_async16(L + i * ld + k, l + i * B + k);
      if (it % 2 == 1) cp_async_commit();
    }
  } else {
    for (int q = tid; q < B * B; q += kThreads) {
      const int i = q / B, k = q % B;
      if (needed(i, k)) L[i * ld + k] = l[q];
    }
  }

  for (int p = q0; p < NB; ++p) {
    if (vec) cp_async_wait(NB - 1 - p);
    __syncthreads();  // block row p of L, and V's block rows before p, are in place
    if (p > q0) GOGP_STAMP(kStampInverse, p - 1);
    else GOGP_STAMP(kStampLoad, 0);

    // The products of block row p: pairs (q, k), q0 <= q < min(p, q1), q <= k < p.
    const int qe = min(p, q1), pairs = (qe - q0) * p - (qe * (qe - 1) - q0 * (q0 - 1)) / 2;
    if (tid < 64 * pairs) {
      int q = q0, k = tid / 64;
      while (k >= p - q) k -= p - q++;  // the (tid / 64)-th pair, block column by block column
      k += q;
      const int t = tid % 64, r0 = 4 * (t / 8), j0 = 4 * (t % 8);
      float acc[4][4] = {};
      gogp::mma_rows<4>(acc, L + (32 * p + r0) * ld + 32 * k, ld, V + 32 * k * ld + 32 * q + j0, ld, 0, 32);
      float* s = scratch(L, q, k);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        gogp::st4(s + (r0 + a) * ld + j0, make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    } else if (warp == kDinvWarp) {
      dinv[32 * p + lane] = 1.0f / L[(32 * p + lane) * ld + 32 * p + lane];
    }
    __syncthreads();
    GOGP_STAMP(kStampPanel, p);
    // The right-hand sides: V_pq = -sum_k L_pk V_kq, the products in k order.
    for (int u = tid; u < (min(p, q1) - q0) * 32 * Q / NB; u += kThreads) {
      const int q = q0 + u / (32 * 8), r = (u / 8) % 32, j = 4 * (u % 8);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = q; k < p; ++k) {
        const float4 t = gogp::ld4(scratch(L, q, k) + r * ld + j);
        acc.x += t.x, acc.y += t.y, acc.z += t.z, acc.w += t.w;
      }
      gogp::st4(V + (32 * p + r) * ld + 32 * q + j, make_float4(-acc.x, -acc.y, -acc.z, -acc.w));
    }
    __syncthreads();
    GOGP_STAMP(kStampUpdate, p);

    // The solves of block row p; meanwhile the idle warps write V's block row p - 1.
    const int q = q0 + warp;
    if (warp < NB && q <= p && q < q1) {
      float* col = V + 32 * p * ld + 32 * q + lane;
      float x[32];
      if (q == p) {
        gogp::diag_solve_column<ld>(L, dinv, 32 * p, x);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = col[i * ld];
        gogp::diag_solve_column<ld, false>(L, dinv, 32 * p, x);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) col[i * ld] = x[i];
      GOGP_STAMP(kStampDiag, p);
    } else if (vec && p > q0 && warp >= NB) {
      store_rows(v, V, p - 1, c0, c1, 32 * NB, kThreads - 32 * NB);
    }
  }
  __syncthreads();
  GOGP_STAMP(kStampInverse, NB - 1);
  if (vec) {
    // the last block row, and the rows above c0 (zeros in this CTA's columns)
    for (int p = 0; p < q0; ++p) store_rows(v, V, p, c0, c1, 0, kThreads);
    store_rows(v, V, NB - 1, c0, c1, 0, kThreads);
  } else {
    for (int q = tid; q < B * B; q += kThreads) {
      const int i = q / B, k = q % B;
      if (k >= c0 && k < c1) v[q] = k <= i ? V[i * ld + k] : 0.0f;
    }
  }
  GOGP_STAMP_SYNC();
  GOGP_STAMP(kStampStore, 0);
}

// The most tiles a stack may have for the split of 4 to be taken, from the
// times chip_smoke.py measured on an H100 (PERF.md): split 4 was the fastest
// at 12 and 32 tiles (by 10%), one CTA a tile at 128 and 200; split 2 was
// never the fastest.
constexpr int kSplit4MaxCount = 32;

int launch(const float* l, float* v, int count, int b, int split, cudaStream_t stream) {
  if (b != B || count < 1 || (split != 1 && split != 2 && split != 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(tril_inv_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<size_t>(l) & 15) == 0 && (reinterpret_cast<size_t>(v) & 15) == 0;
  tril_inv_tiles_kernel<<<dim3(count, split), kThreads, kSmemBytes, stream>>>(l, v, split, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// l and v: (count, b, b), row-major; b must be the tile size.  Only the lower
// triangle of each tile is read.
extern "C" int gogp_tril_inv_tiles(const float* l, float* v, int count, int b, cudaStream_t stream) {
  const int split = count <= kSplit4MaxCount ? 4 : 1;
  return launch(l, v, count, b, split, stream);
}

// The same with the split given (1, 2 or 4 CTAs a tile), for measurement.
extern "C" int gogp_tril_inv_tiles_split(const float* l, float* v, int count, int b, int split,
                                         cudaStream_t stream) {
  return launch(l, v, count, b, split, stream);
}

// The stage stamps of K5's last launch of one tile, as
// gogp_chol_inv_tile_stamps gives K2's.  A build without -DGOGP_TILE_STAMPS
// returns cudaErrorNotSupported.
extern "C" int gogp_tril_inv_tiles_stamps(long long* stamps, int* count, cudaStream_t stream) {
#ifdef GOGP_TILE_STAMPS
  cudaError_t err = cudaMemcpyFromSymbolAsync(stamps, gogp::tile_stamps, sizeof(gogp::tile_stamps), 0,
                                              cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbolAsync(count, gogp::tile_stamp_count, sizeof(int), 0, cudaMemcpyDeviceToDevice,
                                    stream);
  return static_cast<int>(err);
#else
  (void)stamps, (void)count, (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
