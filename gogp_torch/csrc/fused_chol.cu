// K1: the whole-matrix Cholesky factor L of an n x n SPD matrix and the
// stack of its diagonal-tile inverses invs[k] = inv(L_kk), in one launch.
//
// Replaces _fused_chol_kernel / fused_cholesky_invs in
// gogp_tpu/ops/cholesky_pallas.py: a left-looking factorization as one
// sequential-grid program, block column k per grid step, with the whole
// factor resident in VMEM so that no step goes back to HBM or to the host.
// One SM here has 227 KB of shared memory, not 100 MB, so L cannot stay in
// one block.  Instead the kernel is persistent and cooperative: one block of
// 512 threads on every SM (the grid is as large as can be resident at once),
// L in global memory, where at n <= 2047 (16 MB) it stays in the 50 MB L2,
// and grid-wide barriers (cooperative_groups grid.sync) in place of the
// TPU's grid steps.  For each block column k (c0 = 128 k, c1 = c0 + 128):
//
//   1. update: every block takes 32 x 32 tiles of
//        C_k = L[c0:, c0:c1] - L[c0:, :c0] L[c0:c1, :c0]^T
//      in place in L's column block (a tiled FFMA product through shared
//      memory);                                                   grid.sync
//   2. tile: block 0 factors and inverts the diagonal tile C_k[c0:c1] with
//      K2's body (chol_inv_tile_body), writing L_kk into L and V_kk into
//      invs[k];                                                   grid.sync
//   3. panel: every block takes 8-row slabs of L[c1:, c0:c1] = C_k[c1:] V_kk^T,
//      V_kk held once per block in shared memory;                 grid.sync
//
// What bounds it here: latency.  At n = 1536 the whole factorization is
// 1.2 GFLOP, a few tens of microseconds of the card's FP32 rate, but step 2
// runs on one SM while the others wait, and every step costs three grid-wide
// barriers.  Merging step 3 of column k into step 1 of column k + 1, and
// tensor-core tiles for steps 1 and 3, are later work.
//
// Coherence: L and invs are written and read again within the launch by
// other blocks, so every read of them goes through L2 (__ldcg), never through
// L1 or the read-only path (no const __restrict__, no __ldg on them).  A
// non-positive pivot gives NaN, as on the TPU and in K2; no block returns
// early, so every block reaches every grid.sync.  grid.sync needs a
// cooperative launch; it builds without relocatable device code (-rdc).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int B = gogp::kTile;
constexpr int kThreads = gogp::kTileThreads;  // the tile body's block size
constexpr int kUpd = 32;                      // update tiles: kUpd x kUpd, depth kUpd
constexpr int kUpdLd = kUpd + 1;
constexpr int kSlab = 8;                      // panel rows per item
constexpr int kSmemFloats = gogp::kTileSmemFloats<B>;
static_assert(2 * kUpd * kUpdLd <= kSmemFloats, "update tiles fit the tile body's memory");
static_assert(B * gogp::kLd<B> + kSlab * B <= kSmemFloats, "panel fits the tile body's memory");
static_assert(kThreads == 2 * 16 * 16 && kThreads == 4 * B, "thread layouts below");

// Step 1.  Item (u, s): rows r0 = c0 + 32 u ... of L, columns j0 = c0 + 32 s
// ... of the column block.  Thread (ty, tx) = (tid / 32, tid % 32) sums rows
// ty and ty + 16, column tx; the depth runs in chunks of 32 through shared
// memory (rows padded to 33 floats: lane tx reads row tx of Bs without bank
// conflicts, the A row is a broadcast).
__device__ void update_column(float* L, int n, int c0, float* smem) {
  float* As = smem;
  float* Bs = smem + kUpd * kUpdLd;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int items = (n - c0) / kUpd * (B / kUpd);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r0 = c0 + (item / (B / kUpd)) * kUpd;
    const int j0 = c0 + (item % (B / kUpd)) * kUpd;
    const float* arow0 = L + static_cast<size_t>(r0 + ty) * n + tx;
    const float* arow1 = arow0 + static_cast<size_t>(16) * n;
    const float* brow0 = L + static_cast<size_t>(j0 + ty) * n + tx;
    const float* brow1 = brow0 + static_cast<size_t>(16) * n;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    for (int p = 0; p < c0; p += kUpd) {
      As[ty * kUpdLd + tx] = __ldcg(arow0 + p);
      As[(ty + 16) * kUpdLd + tx] = __ldcg(arow1 + p);
      Bs[ty * kUpdLd + tx] = __ldcg(brow0 + p);
      Bs[(ty + 16) * kUpdLd + tx] = __ldcg(brow1 + p);
      __syncthreads();
      const float* a0 = As + ty * kUpdLd;
      const float* a1 = As + (ty + 16) * kUpdLd;
      const float* bt = Bs + tx * kUpdLd;
#pragma unroll
      for (int q = 0; q < kUpd; q += 2) {
        acc0 = fmaf(a0[q], bt[q], acc0);
        acc1 = fmaf(a1[q], bt[q], acc1);
        acc2 = fmaf(a0[q + 1], bt[q + 1], acc2);
        acc3 = fmaf(a1[q + 1], bt[q + 1], acc3);
      }
      __syncthreads();  // As and Bs are read in full before the next chunk
    }
    float* out0 = L + static_cast<size_t>(r0 + ty) * n + j0 + tx;
    float* out1 = out0 + static_cast<size_t>(16) * n;
    *out0 = __ldcg(out0) - (acc0 + acc2);
    *out1 = __ldcg(out1) - (acc1 + acc3);
  }
}

// Step 3.  Item m: rows r0 = c1 + 8 m ... r0 + 7 of L[:, c0:c1], read in full
// into shared memory before any of them is overwritten.  Thread (r, j) =
// (tid / 128, tid % 128) writes column j of rows r and r + 4:
// sum_t C[r][t] V[j][t] (V is zero above its diagonal).  Lane j reads row j
// of V, padded to 129 floats: no bank conflicts.
__device__ void panel(float* L, const float* V, int n, int c0, float* smem) {
  constexpr int ld = gogp::kLd<B>;
  float* Vs = smem;
  float* Cs = smem + B * ld;
  const int c1 = c0 + B;
  const int items = (n - c1) / kSlab;
  if (static_cast<int>(blockIdx.x) >= items) return;
  for (int idx = threadIdx.x; idx < B * B; idx += kThreads)
    Vs[(idx / B) * ld + idx % B] = __ldcg(V + idx);
  const int j = threadIdx.x % B, r = threadIdx.x / B;
  const float* vj = Vs + j * ld;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r0 = c1 + item * kSlab;
    for (int idx = threadIdx.x; idx < kSlab * B; idx += kThreads)
      Cs[idx] = __ldcg(L + static_cast<size_t>(r0 + idx / B) * n + c0 + idx % B);
    __syncthreads();  // Vs (first item) and this slab are in place
    const float* ca = Cs + r * B;
    const float* cb = Cs + (r + 4) * B;
    float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll 8
    for (int t = 0; t < B; t += 2) {
      a0 = fmaf(ca[t], vj[t], a0);
      b0 = fmaf(cb[t], vj[t], b0);
      a1 = fmaf(ca[t + 1], vj[t + 1], a1);
      b1 = fmaf(cb[t + 1], vj[t + 1], b1);
    }
    L[static_cast<size_t>(r0 + r) * n + c0 + j] = a0 + a1;
    L[static_cast<size_t>(r0 + r + 4) * n + c0 + j] = b0 + b1;
    __syncthreads();  // the slab is read in full before the next one lands
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_chol_kernel(const float* __restrict__ k_in, float* L, float* invs, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = n / B;

  // L starts as K's block lower triangle (diagonal tiles whole), zeros above.
  const size_t total = static_cast<size_t>(n) * n;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
    L[idx] = (j / B <= i / B) ? k_in[idx] : 0.0f;
  }
  grid.sync();

  for (int k = 0; k < nb; ++k) {
    const int c0 = k * B;
    if (k > 0) {
      update_column(L, n, c0, smem);
      grid.sync();
    }
    if (blockIdx.x == 0) {
      float* tile = L + static_cast<size_t>(c0) * n + c0;
      gogp::chol_inv_tile_body<B>(tile, n, tile, n, invs + static_cast<size_t>(k) * B * B, B, smem);
    }
    grid.sync();
    if (c0 + B < n) {
      panel(L, invs + static_cast<size_t>(k) * B * B, n, c0, smem);
      grid.sync();
    }
  }
}

}  // namespace

// K (n x n, row-major) -> L (n x n, lower triangular) and invs (n/b, b, b).
// Returns cudaErrorNotSupported on a device without cooperative launch, and
// cudaErrorInvalidValue for b other than the tile size or n not a positive
// multiple of it.
extern "C" int gogp_fused_cholesky_invs(const float* k, float* l, float* invs, int n, int b,
                                        cudaStream_t stream) {
  if (b != B || n < b || n % b != 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int smem = kSmemFloats * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_chol_kernel, kThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&k, &l, &invs, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_chol_kernel), dim3(sms * per_sm),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
