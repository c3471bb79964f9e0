// K6: one tile's Cholesky factor L alone.
//
// Replaces _chol_kernel / pallas_cholesky_tile in
// gogp_tpu/ops/cholesky_pallas.py, the rank-R panel Cholesky of one
// VMEM-resident tile.  No path of either package calls it: the stepwise
// drivers take the tile Cholesky + inverse (K2) wherever a kernel runs.
//
// What bounds it here: latency, as in K2 (chol_inv_tile.cu), whose body it
// runs with the inverse left out (chol_inv_tile_body<B, false> in
// tile_common.cuh): the 32 x 32 diagonal blocks factored and inverted by one
// warp in registers while the other warps apply the previous panel's update
// (look-ahead), the panel solves as products with those inverses, and the
// rank-32 updates as register tiles, without the blocks of inv(L) below the
// diagonal.  A non-positive pivot gives NaN, as on the TPU.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(gogp::kTileThreads)
    chol_tile_kernel(const float* a, int lda, float* l_out, int ldl) {
  extern __shared__ __align__(16) float smem[];
  gogp::chol_inv_tile_body<B, false>(a, lda, l_out, ldl, nullptr, 0, smem);
}

template <int B>
int launch(const float* a, int lda, float* l, int ldl, cudaStream_t stream) {
  constexpr int smem = gogp::kTileSmemFloats<B> * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(chol_tile_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_tile_kernel<B><<<1, gogp::kTileThreads, smem, stream>>>(a, lda, l, ldl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles are row-major with leading dimensions lda, ldl (>= b); l may alias a.
extern "C" int gogp_chol_tile(const float* a, int lda, float* l, int ldl, int b,
                              cudaStream_t stream) {
  if (b != gogp::kTile || lda < b || ldl < b) return static_cast<int>(cudaErrorInvalidValue);
  return launch<gogp::kTile>(a, lda, l, ldl, stream);
}
