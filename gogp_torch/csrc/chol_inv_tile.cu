// K2: one diagonal tile's Cholesky factor L and its inverse V = inv(L).
//
// Replaces _chol_inv_kernel / pallas_cholesky_inv_tile in
// gogp_tpu/ops/cholesky_pallas.py, which factors a VMEM-resident tile in
// rank-32 panels and carries inv(L) along in the same substeps.
//
// What bounds it here: latency.  A 128 x 128 tile is 0.7 MFLOP for the
// factor and as much for the inverse, a few microseconds of one SM's FMA
// rate, but a factorization is a chain of 128 dependent pivots, and every
// step that feeds the next pivot ends in a barrier.  The whole problem stays
// in one block's shared memory (the working tile, which becomes L, and V, in
// rows of 132 floats, plus 31 KB of the panel's transpose, T and scratch),
// and the body (chol_inv_tile_body in tile_common.cuh, which K1, K6 and K7
// also run) keeps only the four 32 x 32 diagonal blocks and, between them,
// one 32-row forward substitution and one 32-column update on the critical
// path: one warp factors a diagonal block in registers (8 columns at a
// time, every lane factoring the 8 x 8 piece itself) while the other warps
// finish the previous panel's update beyond it and form the products T of
// that block row of V (look-ahead); then four warps side by side solve the
// panel's rows, the block row of V below the diagonal and the block's own
// inverse against the diagonal block, as the twin's kernel eliminates
// within its slab; three barriers per 32 columns.
//
// Substitution, not products with the diagonal block's inverse, is what
// keeps ill-conditioned GP tiles finite: on 16 rbf tiles with jitter 1e-5
// (chip_smoke's ill phase) the factor with the panel multiplied by
// inv(L_pp)^T was NaN where cuSOLVER's was not; solved, the factor is
// within 5.2e-2 of each column's scale of f64 (cuSOLVER 9.1e-2) and the
// inverse of its own factor within 2.7e-5 (cuSOLVER's triangular solve
// 2.7e-5).  One tile takes 0.0228 ms (0.0270 with the products; cuSOLVER's
// factor and triangular solve about 0.128), on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke's kernels phase).
//
// The tile is read and written through leading dimensions, so the blocked
// driver factors the diagonal tile in place inside the n x n matrix and
// writes inv(L) straight into its stack of tile inverses.  A stack of tiles
// (the same diagonal tile of each matrix of a (B, n, n) stack) is one
// launch, one CTA a tile, each tile through its own batch stride.  A non-positive
// pivot gives NaN, as on the TPU; the front door's jitter loop sees it.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

// One CTA a tile: tile blockIdx.x of a stack lies sa (sl, sv) floats after
// the one before it.
template <int B>
__global__ void __launch_bounds__(gogp::kTileThreads)
    chol_inv_tile_kernel(const float* a, int lda, long long sa, float* l_out, int ldl, long long sl,
                         float* v_out, int ldv, long long sv) {
  extern __shared__ __align__(16) float smem[];
  const long long t = blockIdx.x;
  gogp::chol_inv_tile_body<B>(a + t * sa, lda, l_out + t * sl, ldl, v_out + t * sv, ldv, smem);
}

template <int B>
int launch(const float* a, int lda, long long sa, float* l, int ldl, long long sl, float* v, int ldv,
           long long sv, int count, cudaStream_t stream) {
  constexpr int smem = gogp::kTileSmemFloats<B> * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(chol_inv_tile_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_tile_kernel<B><<<count, gogp::kTileThreads, smem, stream>>>(a, lda, sa, l, ldl, sl, v, ldv, sv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles are row-major with leading dimensions lda, ldl, ldv (>= b); l may
// alias a, so a factor can be written in place over its input.
extern "C" int gogp_chol_inv_tile(const float* a, int lda, float* l, int ldl,
                                  float* v, int ldv, int b, cudaStream_t stream) {
  if (b != gogp::kTile || lda < b || ldl < b || ldv < b)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<gogp::kTile>(a, lda, 0, l, ldl, 0, v, ldv, 0, 1, stream);
}

// A stack of count tiles in one launch, one CTA a tile: tile t of a starts
// at a + t * sa, of l at l + t * sl, of v at v + t * sv (floats).  So the
// stepwise driver factors the diagonal tiles of a (B, n, n) stack in place,
// B at a time, and writes their inverses into its (B, nb, b, b) stack.
extern "C" int gogp_chol_inv_tiles(const float* a, int lda, long long sa, float* l, int ldl, long long sl,
                                   float* v, int ldv, long long sv, int b, int count, cudaStream_t stream) {
  if (b != gogp::kTile || lda < b || ldl < b || ldv < b || count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<gogp::kTile>(a, lda, sa, l, ldl, sl, v, ldv, sv, count, stream);
}

// The stage stamps of K2's last launch, for measurement: the pairs (stage *
// 8 + panel, clock64()) into stamps (2 * kMaxStamps long longs) and their
// count into count, both device memory, on the stream.  A build without
// -DGOGP_TILE_STAMPS records none and returns cudaErrorNotSupported.
extern "C" int gogp_chol_inv_tile_stamps(long long* stamps, int* count, cudaStream_t stream) {
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

extern "C" const char* gogp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
