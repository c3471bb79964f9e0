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
// 32-wide sub-panels, as the TPU kernel works in rank-32 panels: warp 0
// factors each 32 x 32 diagonal block in registers with shuffles in place of
// barriers (the block has 512 threads, so that a thread may hold a whole row
// without spilling) while the other warps start that block row of V, and
// every inner product runs as several independent chains; five barriers per
// sub-panel.  The body is chol_inv_tile_body in tile_common.cuh, which the
// whole-matrix factorization K1 (fused_chol.cu) runs on its diagonal tiles.
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
  extern __shared__ float smem[];
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

extern "C" const char* gogp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
