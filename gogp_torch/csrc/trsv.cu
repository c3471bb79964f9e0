// K3: streaming triangular vector solves with a blocked factor,
//   z = L^{-1} y      (gogp_trsv_lower)
//   x = L^{-T} z      (gogp_trsv_lower_t)
// with the diagonal tiles applied through their precomputed inverses
// invs[k] = inv(L[kb:(k+1)b, kb:(k+1)b]), the by-product of K1 and K2.
//
// Replaces _trsv_kernel / pallas_trsv_lower and _trsv_t_kernel /
// pallas_trsv_lower_t in gogp_tpu/ops/cholesky_pallas.py.  Those run a
// sequential grid over block rows that carries the solved prefix from one
// step to the next in VMEM scratch.  Blocks of a CUDA grid run in no order
// and share no scratch, so the prefix lives in global memory (x itself) and
// the order is made by flags.
//
// What bounds it here: the chain of nb = n/b dependent block rows (each needs
// every block of x before it), and bytes: a solve reads the strictly lower
// block triangle of L once, n(n-b)/2 floats (32 MB at n = 4096) for 2 FLOPs
// each, which one SM cannot pull at more than a fraction of the card's rate.
// So the solve is a wavefront over the SMs, one CTA per block row:
//
//   - the grid has nb CTAs of 256 threads.  A CTA takes a ticket r from an
//     atomic counter and with it step row r: block out = r of x (forward) or
//     out = nb-1-r (transpose, bottom-up);
//   - CTA r walks its tiles left to right (forward: L[out, c], c = 0..r-1;
//     transpose: L[nb-1-c, out], the column panel from the bottom up) and
//     keeps the row's running sum in registers.  Each tile (64 KB) is held in
//     registers, 16 float4 a thread, a warp reading 512 contiguous bytes of
//     a tile row, and the next tile is loaded before the CTA waits for the
//     block of x the current one multiplies, so the loads are in flight
//     during the wait;
//   - before tile c it waits for ready[c]: one thread spins on an acquire
//     load, the CTA meets at a barrier, and each thread reads what it needs
//     of x's block through L2 (__ldcg);
//   - after the last product the same CTA subtracts the sum from y, applies
//     inv(L_out) (staged in shared memory at the start), writes its block of
//     x, meets at a barrier, and one thread fences and releases ready[r].
//     So a block row costs ONE hand-off between CTAs: the product with the
//     newest block of x and the diagonal solve happen in the same CTA (K4,
//     trsv2d.cu, pays two, product CTA to diagonal CTA to the next product);
//   - the sum over a row is taken left to right, every thread adding its own
//     tile entries in tile order, and the sums across threads meet in a fixed
//     order: no float atomics, the same bits from run to run.
//
// Forward progress: CTA r waits only for ready[c], c < r, set by the CTA
// with ticket c.  A ticket is taken only by a CTA that is already running, so
// the running CTA with the smallest unfinished ticket waits for nothing
// unfinished: the launch cannot hang, whatever order the hardware schedules
// CTAs in and however few fit on the card at once (one per SM here; beyond
// 132 block rows the later CTAs start as earlier ones leave).
//
// Coherence, as in K4: x is written and read by CTAs of the same launch.  A
// writer's threads store, meet at a barrier, one thread fences and publishes
// with a release at device scope; a reader's thread spins on acquire loads,
// its CTA meets at a barrier and reads x through L2, never through L1 or the
// read-only path.  L and invs are only read, with an evict-first hint
// (__ldcs).  The workspace (ticket and ready, 1 + nb ints) is zeroed on the
// stream before each launch.  A NaN in L or y flows into x; no CTA returns
// early and every flag is set, so NaN never hangs the launch.  x lives in
// global memory, so n has no limit of the kernel's own.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

constexpr int B = gogp::kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = B / kWarps;  // tile rows each warp holds
static_assert(B == 4 * 32 && kRows == 16, "the thread layouts below");
// inv(L_out), the cross-warp sums and the diagonal solve's right-hand side
constexpr int kSmemBytes = (B * B + kWarps * B + B) * static_cast<int>(sizeof(float));

using AtomicInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ void wait_until(int* flag, int value) {
  AtomicInt f(*flag);
  while (f.load(cuda::memory_order_acquire) < value) {
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 u, float s) {
  return fmaf(a.w, u.w, fmaf(a.z, u.z, fmaf(a.y, u.y, fmaf(a.x, u.x, s))));
}

__device__ __forceinline__ void axpy4(float4& s, float4 a, float x) {
  s.x = fmaf(a.x, x, s.x);
  s.y = fmaf(a.y, x, s.y);
  s.z = fmaf(a.z, x, s.z);
  s.w = fmaf(a.w, x, s.w);
}

// Rows warp, warp + kWarps, ... of a tile; lane l holds columns 4l .. 4l+3.
struct Tile {
  float4 m[kRows];
};

__device__ __forceinline__ void load_tile(Tile& t, const float* tile, size_t ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    t.m[i] = __ldcs(reinterpret_cast<const float4*>(tile + (warp + kWarps * i) * ld) + lane);
}

// The running sum of a step row.  Forward: dot[i] is this lane's share of
// row warp + kWarps i of (sum_c L[out, c] x[c]).  Transpose: col is this
// warp's share of columns 4 lane .. 4 lane + 3 of (sum_c L[in_c, out]^T x[in_c]).
struct Sum {
  float dot[kRows];
  float4 col;
};

template <bool kTranspose>
__device__ __forceinline__ void consume(Sum& sum, const Tile& t, const float* x_in, int* ready) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) wait_until(ready, 1);
  __syncthreads();
  if (!kTranspose) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(x_in) + lane);
#pragma unroll
    for (int i = 0; i < kRows; ++i) sum.dot[i] = dot4(t.m[i], v, sum.dot[i]);
  } else {
    // lane l (and l + 16) fetches the entry of x that tile row warp + kWarps l meets
    const float xv = __ldcg(x_in + warp + kWarps * (lane & (kRows - 1)));
#pragma unroll
    for (int i = 0; i < kRows; ++i) axpy4(sum.col, t.m[i], __shfl_sync(gogp::kFullMask, xv, i));
  }
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads, 1)
    trsv_wave_kernel(const float* __restrict__ L, const float* __restrict__ y,
                     const float* __restrict__ invs, float* x, int n, int* ticket, int* ready) {
  extern __shared__ __align__(16) float smem[];
  float* inv = smem;              // B x B: inv(L_out)
  float* red = inv + B * B;       // kWarps x B: sums across warps
  float* resid = red + kWarps * B;  // B: y's block, then the diagonal solve's right-hand side
  __shared__ int s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = n / B;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int r = s_ticket;
  const int out = kTranspose ? nb - 1 - r : r;
  const size_t ld = static_cast<size_t>(n);
  // Tile c of the step row and the block of x it multiplies.
  auto block_in = [&](int c) { return kTranspose ? nb - 1 - c : c; };
  auto tile_at = [&](int c) {
    const size_t in = static_cast<size_t>(block_in(c)), o = static_cast<size_t>(out);
    return kTranspose ? L + in * B * ld + o * B : L + o * B * ld + in * B;
  };

  Tile a, b;
  if (r > 0) load_tile(a, tile_at(0), ld);
  // Stage inv(L_out) and y's block; both are first read after a barrier.
  {
    const float* src = invs + static_cast<size_t>(out) * B * B;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp + kWarps * i;
      reinterpret_cast<float4*>(inv + row * B)[lane] =
          __ldcs(reinterpret_cast<const float4*>(src + row * B) + lane);
    }
    if (tid < B) resid[tid] = y[static_cast<size_t>(out) * B + tid];
  }

  Sum sum;
#pragma unroll
  for (int i = 0; i < kRows; ++i) sum.dot[i] = 0.0f;
  sum.col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // Two tiles a step, so that each lives in its own registers: the next tile
  // is requested before the wait for the current one's block of x.
  for (int c = 0; c < r; c += 2) {
    if (c + 1 < r) load_tile(b, tile_at(c + 1), ld);
    consume<kTranspose>(sum, a, x + static_cast<size_t>(block_in(c)) * B, ready + c);
    if (c + 1 < r) {
      if (c + 2 < r) load_tile(a, tile_at(c + 2), ld);
      consume<kTranspose>(sum, b, x + static_cast<size_t>(block_in(c + 1)) * B, ready + c + 1);
    }
  }
  __syncthreads();  // inv and resid are staged (no tile was consumed when r = 0)

  float* x_out = x + static_cast<size_t>(out) * B;
  if (!kTranspose) {
    // resid[row] = y[row] - sum[row]; x[row] = inv[row, :] . resid.  The
    // sixteen reductions of a warp interleave.
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = gogp::warp_sum(sum.dot[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) resid[warp + kWarps * i] -= s[i];
    }
    __syncthreads();
    const float4 v = reinterpret_cast<const float4*>(resid)[lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      s[i] = gogp::warp_sum(dot4(reinterpret_cast<const float4*>(inv + (warp + kWarps * i) * B)[lane], v, 0.0f));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) x_out[warp + kWarps * i] = s[i];
    }
  } else {
    // resid[col] = z[col] - sum over warps; x[col] = inv[:, col] . resid.
    reinterpret_cast<float4*>(red + warp * B)[lane] = sum.col;
    __syncthreads();
    if (tid < B) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * B + tid];
      resid[tid] -= s;
    }
    __syncthreads();
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = warp + kWarps * i;
      axpy4(acc, reinterpret_cast<const float4*>(inv + row * B)[lane], resid[row]);
    }
    reinterpret_cast<float4*>(red + warp * B)[lane] = acc;  // red was last read before the barrier above
    __syncthreads();
    if (tid < B) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * B + tid];
      x_out[tid] = s;
    }
  }

  __syncthreads();  // x's block is written in full before it is published
  if (tid == 0) {
    __threadfence();
    AtomicInt(ready[r]).store(1, cuda::memory_order_release);
  }
}

int launch(bool transpose, const float* L, const float* y, const float* invs, float* x,
           int* counters, int n, int b, cudaStream_t stream) {
  if (b != B || n < B || n % B != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n / B;
  cudaError_t err = cudaMemsetAsync(counters, 0, (1 + static_cast<size_t>(nb)) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = transpose ? trsv_wave_kernel<true> : trsv_wave_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nb, kThreads, kSmemBytes, stream>>>(L, y, invs, x, n, counters, counters + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (n x n, row-major, 16-byte aligned; only its strictly lower block
// triangle is read), y and x (n), invs (n/b, b, b, 16-byte aligned); b must be
// the tile size and n a multiple of it.  Workspace from the caller: counters
// (1 + n/b ints, zeroed here on the stream).
extern "C" int gogp_trsv_lower(const float* L, const float* y, const float* invs, float* x,
                               int* counters, int n, int b, cudaStream_t stream) {
  return launch(false, L, y, invs, x, counters, n, b, stream);
}

extern "C" int gogp_trsv_lower_t(const float* L, const float* z, const float* invs, float* x,
                                 int* counters, int n, int b, cudaStream_t stream) {
  return launch(true, L, z, invs, x, counters, n, b, stream);
}
