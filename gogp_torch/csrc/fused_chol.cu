// K1: the whole-matrix Cholesky factor L of an n x n SPD matrix and the
// stack of its diagonal-tile inverses invs[k] = inv(L_kk), in one launch.
//
// Replaces _fused_chol_kernel / fused_cholesky_invs in
// gogp_tpu/ops/cholesky_pallas.py: a left-looking factorization as one
// sequential-grid program, block column k per grid step, with the whole
// factor resident in VMEM so that no step goes back to HBM or to the host.
// One SM here has 227 KB of shared memory, not 100 MB, so L lives in global
// memory (64 MB at n = 4096, the wrapper's largest n, against a 50 MB L2),
// and the grid steps become a dataflow over the SMs.  With b = 128 and nb = n / b, block
// column k is three kinds of work item, left-looking:
//
//   piece (k, q), q < 10: a 32 x 32 piece of the diagonal tile's lower
//     triangle, C = A_kk - sum_{m<k} L_km L_km^T restricted to the piece,
//     written in place into L's diagonal tile;
//   diag k: once its 10 pieces are in, the tile body (tile_common.cuh,
//     chol_inv_tile_body, one CTA) factors the tile in place and writes
//     inv(L_kk) into invs[k];
//   slab (k, i, r), i > k, r < 4: 32 rows of tile (i, k),
//     C = A_ik - sum_{m<k} L_im L_km^T, then, once diag k is done,
//     L_ik = C inv(L_kk)^T; it also writes the zeros of the same rows of
//     the upper tile (k, i).
//
// Each CTA (one per SM, 512 threads, the tile body's shape) takes items by
// ticket from an atomic counter, in the order column by column: pieces,
// diag, slabs (tile row k + 1 first).  An item waits for what it reads with
// acquire loads on per-item counters: a piece or slab for the slabs of
// earlier columns in the rows it multiplies, a slab for diag k, diag k for
// its 10 pieces.  The sums over m take one block column of depth at a time
// as soon as it is in, so the products of the early columns are done long
// before the newest panel lands (look-ahead), and no grid-wide barrier is
// left: the critical path is nb x (tile body + one slab's product with
// inv(L_kk) + one piece's last block column + three hand-offs).
//
// What bounds it here: that chain.  At n = 1536 the factorization is 1.2
// GFLOP, about 18 us of the card's f32 FMA rate over all SMs, but the
// diagonal tiles are factored one after another, each on one SM.
//
// Forward progress: an item waits only for items with smaller tickets (every
// dependency above points to an earlier column, or to the diag or pieces
// before it in the same column).  A ticket is taken only by a CTA that is
// already running, so the running CTA with the smallest unfinished ticket
// waits for nothing unfinished: the launch cannot hang, whatever order the
// CTAs run in and however few of them are resident.
//
// Coherence, as in K3 (trsv.cu): a writer's threads store, meet at a
// barrier, and one thread fences and publishes with a release at device
// scope; a reader's thread spins on acquire loads, its CTA meets at a
// barrier and reads L and invs through L2 (__ldcg), never through L1 or the
// read-only path.  K is only read.  The counters (the ticket, per column the
// pieces in and the diag done, per tile the slabs in; 1 + 2 nb + nb^2 ints)
// are zeroed on the stream before each launch.  Every sum runs in a fixed
// order in one CTA: no float atomics, the same bits from run to run.  A
// non-positive pivot gives NaN, as on the TPU and in K2, which flows into
// every later column; no item returns early and every counter is published,
// so NaN never hangs the launch.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr int B = gogp::kTile;
constexpr int kThreads = gogp::kTileThreads;  // the tile body's block size
constexpr int kPieces = 10;                   // 32 x 32 pieces of a tile's lower triangle
constexpr int kLdS = B + 4;                   // rows of the staged operands: float4-aligned, conflict-free
constexpr int kSmemFloats = gogp::kTileSmemFloats<B>;
static_assert((32 + B) * kLdS <= kSmemFloats, "a slab's operands fit the tile body's memory");
static_assert(kThreads == 512 && B == 128, "the thread layouts below");

using AtomicInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ void wait_until(int* flag, int value) {
  AtomicInt f(*flag);
  while (f.load(cuda::memory_order_acquire) < value) {
  }
}

// After the CTA's barrier: make its writes visible, then count them in.
__device__ __forceinline__ void publish(int* flag) {
  __threadfence();
  AtomicInt(*flag).fetch_add(1, cuda::memory_order_release);
}

// Counters in the workspace after the ticket.
struct Flags {
  int* pieces;  // [k]: pieces of diagonal tile k in
  int* diag;    // [k]: diag k done
  int* slabs;   // [m * nb + i]: slabs of tile (i, m) in
};

// Rows [r0, r0 + Rows) x columns [c0, c0 + B) of a row-major matrix with
// leading dimension ld into s (kLdS a row), through L2, every load in flight
// before the first store.
template <int Rows>
__device__ __forceinline__ void stage(float* s, const float* src, size_t ld, int r0, int c0) {
  constexpr int Q = B / 4, kIt = Rows * Q / kThreads;
  static_assert(Rows * Q % kThreads == 0, "whole float4s per thread");
  float4 v[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int q = threadIdx.x + it * kThreads;
    v[it] = __ldcg(reinterpret_cast<const float4*>(src + (r0 + q / Q) * ld + c0) + q % Q);
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int q = threadIdx.x + it * kThreads;
    gogp::st4(s + (q / Q) * kLdS + 4 * (q % Q), v[it]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc[a][b] += sum_t X[r + a][t] Y[lane + 32 b][t] over the B columns of the
// staged X (32 rows) and Y (B rows): rows r = 2 warp, shared by the warp
// (broadcast reads), Y's rows one per lane (conflict-free float4 reads).
__device__ __forceinline__ void slab_mma(float (&acc)[2][4], const float* X, const float* Y) {
  const int lane = threadIdx.x & 31, r = 2 * (threadIdx.x >> 5);
#pragma unroll 4
  for (int t = 0; t < B; t += 4) {
    const float4 x0 = gogp::ld4(X + r * kLdS + t), x1 = gogp::ld4(X + (r + 1) * kLdS + t);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 y = gogp::ld4(Y + (lane + 32 * b) * kLdS + t);
      acc[0][b] = dot4(x0, y, acc[0][b]);
      acc[1][b] = dot4(x1, y, acc[1][b]);
    }
  }
}

// acc[b] += sum_t X[r][t] Y[c + 16 b][t] for the 32 x 32 piece: row r =
// tid / 16, columns c = tid % 16 and c + 16.
__device__ __forceinline__ void piece_mma(float (&acc)[2], const float* X, const float* Y) {
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll 4
  for (int t = 0; t < B; t += 4) {
    const float4 x = gogp::ld4(X + r * kLdS + t);
    acc[0] = dot4(x, gogp::ld4(Y + c * kLdS + t), acc[0]);
    acc[1] = dot4(x, gogp::ld4(Y + (c + 16) * kLdS + t), acc[1]);
  }
}

// Piece (pr, pc) of diagonal tile k: rows k b + 32 pr ..., columns k b + 32 pc ...
__device__ void run_piece(const float* K, float* L, int n, int nb, int k, int q, Flags f, float* smem) {
  int pr = 0;
  while ((pr + 1) * (pr + 2) / 2 <= q) ++pr;
  const int pc = q - pr * (pr + 1) / 2;
  const int r0 = k * B + 32 * pr, c0 = k * B + 32 * pc;
  float* X = smem;
  float* Y = smem + 32 * kLdS;
  float acc[2] = {0.0f, 0.0f};
  for (int m = 0; m < k; ++m) {
    if (threadIdx.x == 0) wait_until(f.slabs + m * nb + k, 4);
    __syncthreads();
    stage<32>(X, L, n, r0, m * B);
    stage<32>(Y, L, n, c0, m * B);
    __syncthreads();
    piece_mma(acc, X, Y);
    __syncthreads();  // X and Y are read in full before the next stage
  }
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const size_t idx = static_cast<size_t>(r0 + r) * n + c0 + c + 16 * b;
    L[idx] = K[idx] - acc[b];
  }
  __syncthreads();
  if (threadIdx.x == 0) publish(f.pieces + k);
}

__device__ void run_diag(float* L, float* invs, int n, int k, Flags f, float* smem) {
  if (threadIdx.x == 0) wait_until(f.pieces + k, kPieces);
  __syncthreads();
  float* tile = L + static_cast<size_t>(k) * B * n + k * B;
  gogp::chol_inv_tile_body<B>(tile, n, tile, n, invs + static_cast<size_t>(k) * B * B, B, smem);
  __syncthreads();
  if (threadIdx.x == 0) publish(f.diag + k);
}

// Slab r of tile (i, k): rows i b + 32 r ..., columns k b ...
__device__ void run_slab(const float* K, float* L, const float* invs, int n, int nb, int k, int i, int r,
                         Flags f, float* smem) {
  const int r0 = i * B + 32 * r, lane = threadIdx.x & 31, row = 2 * (threadIdx.x >> 5);
  float* X = smem;
  float* Y = smem + 32 * kLdS;
  float acc[2][4] = {};
  for (int m = 0; m < k; ++m) {
    if (threadIdx.x == 0) {
      wait_until(f.slabs + m * nb + i, 4);
      wait_until(f.slabs + m * nb + k, 4);
    }
    __syncthreads();
    stage<32>(X, L, n, r0, m * B);
    stage<B>(Y, L, n, k * B, m * B);
    __syncthreads();
    slab_mma(acc, X, Y);
    __syncthreads();  // X and Y are read in full before the next stage
  }
  // C = A - acc into X, then L_ik = C inv(L_kk)^T
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      X[(row + a) * kLdS + lane + 32 * b] =
          K[static_cast<size_t>(r0 + row + a) * n + k * B + lane + 32 * b] - acc[a][b];
  if (threadIdx.x == 0) wait_until(f.diag + k, 1);
  __syncthreads();
  stage<B>(Y, invs + static_cast<size_t>(k) * B * B, B, 0, 0);
  __syncthreads();
  float out[2][4] = {};
  slab_mma(out, X, Y);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) L[static_cast<size_t>(r0 + row + a) * n + k * B + lane + 32 * b] = out[a][b];
  // the same rows of the upper tile (k, i) are zero
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int it = 0; it < 32 * B / 4 / kThreads; ++it) {
    const int q = threadIdx.x + it * kThreads;
    gogp::st4(L + static_cast<size_t>(k * B + 32 * r + q / (B / 4)) * n + i * B + 4 * (q % (B / 4)), zero);
  }
  __syncthreads();
  if (threadIdx.x == 0) publish(f.slabs + k * nb + i);
}

__device__ __forceinline__ int items_in_column(int nb, int k) { return kPieces + 1 + 4 * (nb - 1 - k); }

__global__ void __launch_bounds__(kThreads, 1)
    fused_chol_kernel(const float* __restrict__ K, float* L, float* invs, int* work, int n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_ticket;
  const int nb = n / B;
  const Flags f{work + 1, work + 1 + nb, work + 1 + 2 * nb};
  int total = 0;
  for (int k = 0; k < nb; ++k) total += items_in_column(nb, k);

  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(work, 1);
    __syncthreads();
    int t = s_ticket;
    __syncthreads();  // every thread has its ticket before thread 0 takes the next
    if (t >= total) break;
    int k = 0;
    while (t >= items_in_column(nb, k)) t -= items_in_column(nb, k++);
    if (t < kPieces) {
      run_piece(K, L, n, nb, k, t, f, smem);
    } else if (t == kPieces) {
      run_diag(L, invs, n, k, f, smem);
    } else {
      t -= kPieces + 1;
      run_slab(K, L, invs, n, nb, k, k + 1 + t / 4, t % 4, f, smem);
    }
  }
}

}  // namespace

// K (n x n, row-major) -> L (n x n, lower triangular) and invs (n/b, b, b).
// work: 1 + 2 n/b + (n/b)^2 ints, zeroed here on the stream.  Returns
// cudaErrorInvalidValue for b other than the tile size or n not a positive
// multiple of it.
extern "C" int gogp_fused_cholesky_invs(const float* k, float* l, float* invs, int* work, int n, int b,
                                        cudaStream_t stream) {
  if (b != B || n < b || n % b != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n / b;
  int dev = 0, sms = 0, total = 0;
  for (int c = 0; c < nb; ++c) total += kPieces + 1 + 4 * (nb - 1 - c);
  constexpr int smem = kSmemFloats * static_cast<int>(sizeof(float));
  static_assert(smem <= gogp::kMaxSharedBytes, "tile does not fit shared memory");
  cudaError_t err = cudaMemsetAsync(work, 0, (1 + 2 * static_cast<size_t>(nb) + static_cast<size_t>(nb) * nb) * sizeof(int),
                                    stream);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_chol_kernel<<<total < sms ? total : sms, kThreads, smem, stream>>>(k, l, invs, work, n);
  return static_cast<int>(cudaGetLastError());
}
