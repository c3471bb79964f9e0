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
// rows of 132 floats, plus 36 KB of transposed copies and scratch), and the
// body (chol_inv_tile_body in tile_common.cuh, which K1, K6 and K7 also run)
// keeps only the four 32 x 32 diagonal blocks and one panel and 32-column
// update between them on the critical path: one warp factors and inverts a
// diagonal block in registers (8 columns at a time, every lane factoring the
// 8 x 8 piece itself) while the other warps finish the previous panel's update
// beyond it and start that block row of V (look-ahead); every product is a
// register tile read as float4 rows; four barriers per 32 columns.
//
// The tile is read and written through leading dimensions, so the blocked
// driver factors the diagonal tile in place inside the n x n matrix and
// writes inv(L) straight into its stack of tile inverses.  A non-positive
// pivot gives NaN, as on the TPU; the front door's jitter loop sees it.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(gogp::kTileThreads)
    chol_inv_tile_kernel(const float* a, int lda, float* l_out, int ldl, float* v_out, int ldv) {
  extern __shared__ __align__(16) float smem[];
  gogp::chol_inv_tile_body<B>(a, lda, l_out, ldl, v_out, ldv, smem);
}

template <int B>
int launch(const float* a, int lda, float* l, int ldl, float* v, int ldv, cudaStream_t stream) {
  constexpr int smem = gogp::kTileSmemFloats<B> * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(chol_inv_tile_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inv_tile_kernel<B><<<1, gogp::kTileThreads, smem, stream>>>(a, lda, l, ldl, v, ldv);
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
