// K5: inverse of a stack of lower-triangular tiles, V[t] = inv(L[t]).
//
// Replaces _tril_inv_kernel / pallas_tril_inv_tile in
// gogp_tpu/ops/cholesky_pallas.py (rank-8 forward substitution of one
// VMEM-resident tile), and _tile_invs, which vmaps it over the (nb, b, b)
// diagonal tiles: here the whole stack is one launch with one block per tile.
//
// What bounds it here: latency.  inv(L) of a 128-tile is 0.7 MFLOP on
// 64 KB, but forward substitution is a chain of dependent row steps.  The
// design loads the tile once into shared memory (rows padded by one word, so
// rows and columns both read without bank conflicts), inverts its 32 x 32
// diagonal blocks with one warp per column and shuffles in place of barriers
// (inv32_column), and builds the blocks below the diagonal from block
// products (inv_row_partial, inv_row_finish): 2 barriers per block row.  The nb tiles of a
// factor run on nb SMs at once.
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(1024)
    tril_inv_tiles_kernel(const float* __restrict__ l, float* __restrict__ v) {
  constexpr int ld = gogp::kLd<B>;
  extern __shared__ float smem[];
  float* L = smem;
  float* V = L + B * ld;
  float* T = V + B * ld;                 // (B/32 - 1) blocks for inv_row_partial
  float* dinv = T + (B / 32 - 1) * 1024; // B reciprocal pivots
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * B * B;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) L[(idx / B) * ld + idx % B] = l[base + idx];
  __syncthreads();
  if (threadIdx.x < B) dinv[threadIdx.x] = 1.0f / L[threadIdx.x * ld + threadIdx.x];
  __syncthreads();
  for (int c = 0; c < B; c += 32) gogp::inv32_column(L, V, ld, c, warp, dinv);
  __syncthreads();
  for (int p = 1; p < B / 32; ++p) {
    gogp::inv_row_partial<B>(L, V, T, p, warp, 32);
    __syncthreads();
    gogp::inv_row_finish<B>(V, T, p, warp, 32);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int i = idx / B, k = idx % B;
    v[base + idx] = (k <= i) ? V[i * ld + k] : 0.0f;
  }
}

template <int B>
int launch(const float* l, float* v, int count, cudaStream_t stream) {
  constexpr int smem = (2 * B * gogp::kLd<B> + gogp::kScratch<B>) * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(tril_inv_tiles_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tril_inv_tiles_kernel<B><<<count, 1024, smem, stream>>>(l, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gogp_tril_inv_tiles(const float* l, float* v, int count, int b,
                                   cudaStream_t stream) {
  if (b != gogp::kTile || count < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<gogp::kTile>(l, v, count, stream);
}
