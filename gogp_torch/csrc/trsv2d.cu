// K4: triangular vector solves over the triangular grid of (b, b) tiles,
//   z = L^{-1} y      (gogp_trsv2d_lower)
//   x = L^{-T} z      (gogp_trsv2d_lower_t)
// with the diagonal tiles applied through their inverses invs[k] (the
// by-product of K1 and K2), one solve spread over every SM.
//
// Replaces _trsv2d_kernel / pallas_trsv2d_lower and _trsv2d_t_kernel /
// pallas_trsv2d_lower_t in gogp_tpu/ops/cholesky_pallas.py.  Those visit the
// tiles of the lower triangle in a sequential grid, row-major (_tri_kj), one
// tile per step, and carry the solved prefix and the row's running sum in
// VMEM scratch: on the TPU their point is to hold one tile whatever n is.
//
// What bounds it here: bytes, and the chain of nb = n/b block rows.  A solve
// reads the strictly lower block triangle of L once (n(n-b)/2 floats, 533 MB
// at n = 16384) for 2 FLOPs each, and block row r of x needs every block
// before it.  K3 (trsv.cu) gives each block row one CTA that streams the
// whole row; here the row is cut into work items that any CTA may take:
//
//   - step row r solves block out = r of x (forward) or out = nb-1-r
//     (transpose, bottom-up); its tile c < r is L[out, c] (forward) or
//     L[nb-1-c, nb-1-r]^T (transpose), times block c (or nb-1-c) of x;
//   - the row's tiles c <= r - 2 are summed off the chain by segment items
//     of kSegment tiles each, which stream their tiles as the blocks of x
//     they multiply are published, write their sum to a slot of their own
//     and count themselves into done[r];
//   - the row's chain item holds tile r - 1 in registers and inv(L_out) in
//     shared memory, waits for done[r], subtracts the slots from y in a fixed
//     order, then waits for block r - 1 of x, multiplies, applies inv(L_out),
//     writes block r of x and sets ready[r].  So a block row costs one
//     hand-off between CTAs on the chain, as in K3, and the segments' sums
//     are ready before the chain reaches the row;
//   - the grid is persistent, one CTA per SM (as many as fit), and each CTA
//     takes items by atomic ticket until none is left: row by row, the
//     row's segments, then its chain item (first_item).
//
// Forward progress: an item waits only for items of smaller tickets (a
// segment for chain items of rows <= r - 2, a chain item for its row's
// segments and the chain item before it).  A ticket is taken only by a CTA
// that is running and has finished its last item, so the CTA with the
// smallest unfinished ticket runs and waits for nothing unfinished: the
// launch cannot hang, however many CTAs fit on the card.
//
// A batch of solves (L (batch, n, n), y and x (batch, n), invs (batch, nb,
// b, b)) is one launch: the tickets take step row r of every solve before
// step row r + 1 of any, and within a row each solve's segments, then its
// chain item.  An item still waits only on items of smaller tickets (rows
// before its own, and its own solve's segments of its row), so the argument
// above holds; each solve has its own done and ready flags and slots.  At
// n = 1024 one solve is a chain of nb = 8 items: the batch's chains side by
// side are what gives the SMs work.
//
// Coherence: x and the segments' sums are written and read by CTAs of the
// same launch.  A writer's threads store, meet at a barrier, and one thread
// publishes with a release at device scope; a reader's thread spins on
// acquire loads, its CTA meets at a barrier, and reads the data through L2
// (__ldcg), never through L1 or the read-only path.  L and the tile inverses
// are only read, with an evict-first hint (__ldcs).  Every sum runs in a
// fixed order: no float atomics, the same bits from run to run.  The counters
// (ticket, done, ready) are zeroed on the stream before each launch.  A NaN
// in L or y flows into x; no item returns early and every flag is set, so NaN
// never hangs the launch.
//
// With -DGOGP_TRSV_STAMPS (chip_smoke.py --phases stamps) thread 0 of each
// chain item records clock64() and %globaltimer at each stage of the chain
// step; gogp_trsv2d_stamps copies them out.  The normal build records nothing.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "tile_common.cuh"

namespace {

constexpr int B = gogp::kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = B / kWarps;  // tile rows each warp holds
static_assert(B == 4 * 32 && kRows == 16, "the thread layouts below");
// Shared memory of a CTA that applies a diagonal tile: inv(L_out), the
// cross-warp sums and the diagonal solve's right-hand side.
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

// A running sum of tile products.  Forward: dot[i] is this lane's share of
// row warp + kWarps i of (sum_c L[out, c] x[c]).  Transpose: col is this
// warp's share of columns 4 lane .. 4 lane + 3 of (sum_c L[in_c, out]^T x[in_c]).
struct Sum {
  float dot[kRows];
  float4 col;
};

__device__ __forceinline__ void zero(Sum& sum) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) sum.dot[i] = 0.0f;
  sum.col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Adds the tile's product with x_in's block, read through L2.
template <bool kTranspose>
__device__ __forceinline__ void multiply(Sum& sum, const Tile& t, const float* x_in) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

// Waits for the flag of x_in's block, then adds the tile's product with it.
template <bool kTranspose>
__device__ __forceinline__ void consume(Sum& sum, const Tile& t, const float* x_in, int* ready) {
  if (threadIdx.x == 0) wait_until(ready, 1);
  __syncthreads();
  multiply<kTranspose>(sum, t, x_in);
}

// Tiles c in [c0, c1) of a step row, c0 < c1, added to sum in that order:
// tile_at(c) is the tile, x_at(c) the block of x it multiplies and ready + c
// its flag.  Two tiles a step, so that each lives in its own registers: the
// next tile is requested before the wait for the current one's block of x.
template <bool kTranspose, class TileAt, class XAt>
__device__ __forceinline__ void consume_tiles(Sum& sum, int c0, int c1, size_t ld, TileAt tile_at, XAt x_at,
                                              int* ready) {
  Tile a, b;
  load_tile(a, tile_at(c0), ld);
  for (int c = c0; c < c1; c += 2) {
    if (c + 1 < c1) load_tile(b, tile_at(c + 1), ld);
    consume<kTranspose>(sum, a, x_at(c), ready + c);
    if (c + 1 < c1) {
      if (c + 2 < c1) load_tile(a, tile_at(c + 2), ld);
      consume<kTranspose>(sum, b, x_at(c + 1), ready + c + 1);
    }
  }
}

// The shared memory of a CTA that applies a diagonal tile (kSmemBytes).
struct DiagSmem {
  float* inv;    // B x B: inv(L_out)
  float* red;    // kWarps x B: sums across warps
  float* resid;  // B: y's block, then the diagonal solve's right-hand side
};

__device__ __forceinline__ DiagSmem diag_smem(float* smem) { return {smem, smem + B * B, smem + B * B + kWarps * B}; }

// Stages inv(L_out) and y's block; both are first read after a barrier.
__device__ __forceinline__ void stage_diag(const DiagSmem& s, const float* inv_out, const float* y_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = warp + kWarps * i;
    reinterpret_cast<float4*>(s.inv + row * B)[lane] =
        __ldcs(reinterpret_cast<const float4*>(inv_out + row * B) + lane);
  }
  if (threadIdx.x < B) s.resid[threadIdx.x] = y_out[threadIdx.x];
}

constexpr int kSegment = 8;  // tiles of a segment item

struct Workspace {
  int* ticket;     // 1
  int* done;       // batch x nb: finished segments of each step row
  int* ready;      // batch x nb: step row r has written its block of x
  float* partial;  // one B-float slot per item
};

// Segment items of step row r: its tiles c <= r - 2, kSegment at a time.
__host__ __device__ __forceinline__ int segments(int r) { return r >= 2 ? (r - 2) / kSegment + 1 : 0; }

// Ticket of step row r's first item; rows before it take segments(q) + 1
// tickets each, and sum_{q=2}^{r-1} segments(q) = sum_{j<m} (j / kSegment + 1),
// m = r - 2.  first_item(nb) is the number of items.
__host__ __device__ __forceinline__ long long first_item(int r) {
  if (r <= 2) return r;
  const long long m = r - 2, k = m / kSegment;
  return r + m + kSegment * k * (k - 1) / 2 + k * (m - k * kSegment);
}

// Stages of a chain item's step, for the stamps build.
enum ChainStage {
  kStart, kPartials, kSeen, kMet, kProduct, kReduced, kApplied, kBarrier, kReleased, kChainStages
};
#ifdef GOGP_TRSV_STAMPS
constexpr int kMaxStampRows = 512;
static __device__ long long chain_stamps[kMaxStampRows][kChainStages][2];
__device__ __forceinline__ void stamp(int r, int stage) {
  if (threadIdx.x != 0 || r >= kMaxStampRows) return;
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  chain_stamps[r][stage][0] = clock64();
  chain_stamps[r][stage][1] = ns;
}
#define STAMP(r, stage) stamp(r, stage)
#else
#define STAMP(r, stage) ((void)0)
#endif

// K4's chain step, shorter than K3's (trsv.cu):
//
//   - one fence a hand-off: the flag is set by a release at device scope
//     right after the CTA's barrier, as CUTLASS's semaphore does; K3 adds a
//     __threadfence before its release store, which fences again (about 700
//     cycles on an H100);
//   - forward, a warp's 16 row sums meet in a butterfly that halves the
//     values at each of its 5 steps (16 shuffles), where 16 warp sums take
//     80.

// Sums v[i] over the warp's lanes for each of the 16 i; lane l returns the
// sum for i = l >> 1.  A fixed order, so the same bits from run to run.
__device__ __forceinline__ float warp_sum16(const float (&v)[kRows]) {
  static_assert(kRows == 16, "a butterfly of 16 values");
  const int lane = threadIdx.x & 31;
  float a8[8], a4[4], a2[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hi = lane & 16;
    a8[k] = (hi ? v[k + 8] : v[k]) + __shfl_xor_sync(gogp::kFullMask, hi ? v[k] : v[k + 8], 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 8;
    a4[k] = (hi ? a8[k + 4] : a8[k]) + __shfl_xor_sync(gogp::kFullMask, hi ? a8[k] : a8[k + 4], 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 4;
    a2[k] = (hi ? a4[k + 2] : a4[k]) + __shfl_xor_sync(gogp::kFullMask, hi ? a4[k] : a4[k + 2], 4);
  }
  const bool hi = lane & 2;
  const float a1 = (hi ? a2[1] : a2[0]) + __shfl_xor_sync(gogp::kFullMask, hi ? a2[0] : a2[1], 2);
  return a1 + __shfl_xor_sync(gogp::kFullMask, a1, 1);
}

// The CTA's sum of a running sum into dst (B floats), or subtracted from it:
// forward, the warps' rows from warp_sum16; transpose, the warps' shares
// meet in red.  Only red is touched in shared memory.
template <bool kTranspose>
__device__ __forceinline__ void reduce_rows(float* dst, const Sum& sum, float* red, bool subtract) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kTranspose) {
    reinterpret_cast<float4*>(red + warp * B)[lane] = sum.col;
    __syncthreads();
    if (tid < B) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q * B + tid];
      dst[tid] = subtract ? dst[tid] - s : s;
    }
  } else {
    const float s = warp_sum16(sum.dot);
    if (!(lane & 1)) {
      float& d = dst[warp + kWarps * (lane >> 1)];
      d = subtract ? d - s : s;
    }
  }
}

// After the CTA's stores: a barrier, then thread 0 sets the flag to 1 or,
// with count, adds one, by a release at device scope.
__device__ __forceinline__ void release_flag(int* flag, bool count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (count)
      AtomicInt(*flag).fetch_add(1, cuda::memory_order_release);
    else
      AtomicInt(*flag).store(1, cuda::memory_order_release);
  }
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads, 1)
    trsv2d_kernel(const float* __restrict__ L_all, const float* __restrict__ y_all,
                  const float* __restrict__ invs_all, float* x_all, int n, int batch, Workspace w) {
  extern __shared__ __align__(16) float smem[];
  const DiagSmem ds = diag_smem(smem);
  __shared__ int s_row, s_elem, s_item;
  const int tid = threadIdx.x;
  const int nb = n / B;
  const long long items = first_item(nb);  // of one solve
  const size_t ld = static_cast<size_t>(n);

  for (;;) {
    if (tid == 0) {
      // Ticket t: step row r of every solve (batch (segments(r) + 1) tickets)
      // after the rows before it, element e's items within the row.
      const long long t = atomicAdd(w.ticket, 1);
      int r = -1, e = 0, j = 0;
      if (t < batch * items) {  // the last row whose first ticket is <= t
        int lo = 0, hi = nb - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (batch * first_item(mid) <= t) lo = mid; else hi = mid - 1;
        }
        r = lo;
        const long long local = t - batch * first_item(r), per = segments(r) + 1;
        e = static_cast<int>(local / per);
        j = static_cast<int>(local % per);
      }
      s_row = r;
      s_elem = e;
      s_item = j;
    }
    __syncthreads();
    // Every item below passes a barrier before thread 0 writes these again.
    const int r = s_row, e = s_elem, j = s_item;
    if (r < 0) break;
    const float* L = L_all + static_cast<size_t>(e) * ld * ld;
    const float* y = y_all + static_cast<size_t>(e) * ld;
    const float* invs = invs_all + static_cast<size_t>(e) * nb * B * B;
    float* x = x_all + static_cast<size_t>(e) * ld;
    int* done = w.done + static_cast<size_t>(e) * nb;
    int* ready = w.ready + static_cast<size_t>(e) * nb;
    const int out = kTranspose ? nb - 1 - r : r;
    const auto block_in = [&](int c) { return kTranspose ? nb - 1 - c : c; };
    const auto tile_at = [&](int c) {
      const size_t in = static_cast<size_t>(block_in(c)), o = static_cast<size_t>(out);
      return kTranspose ? L + in * B * ld + o * B : L + o * B * ld + in * B;
    };
    const auto x_at = [&](int c) { return x + static_cast<size_t>(block_in(c)) * B; };
    float* slots = w.partial + static_cast<size_t>(e * items + first_item(r)) * B;
    const int segs = segments(r);
    Sum sum;
    zero(sum);

    if (j < segs) {
      // Segment j: tiles [j kSegment, min((j + 1) kSegment, r - 1)).
      const int c0 = j * kSegment, c1 = min(c0 + kSegment, r - 1);
      consume_tiles<kTranspose>(sum, c0, c1, ld, tile_at, x_at, ready);
      reduce_rows<kTranspose>(slots + static_cast<size_t>(j) * B, sum, ds.red, false);
      release_flag(done + r, true);
      continue;
    }

    // The chain item.
    STAMP(r, kStart);
    Tile a;
    if (r > 0) load_tile(a, tile_at(r - 1), ld);
    stage_diag(ds, invs + static_cast<size_t>(out) * B * B, y + static_cast<size_t>(out) * B);
    if (segs > 0) {
      if (tid == 0) wait_until(done + r, segs);
      __syncthreads();
      if (tid < B) {  // the thread that staged resid[tid]
        float s = 0.0f;
        for (int q = 0; q < segs; ++q) s += __ldcg(slots + static_cast<size_t>(q) * B + tid);
        ds.resid[tid] -= s;
      }
    }
    STAMP(r, kPartials);
    if (r > 0) {
      if (tid == 0) wait_until(ready + r - 1, 1);
      STAMP(r, kSeen);
    }
    __syncthreads();  // inv and resid are staged; block r - 1 of x is published
    STAMP(r, kMet);
    if (r > 0) multiply<kTranspose>(sum, a, x_at(r - 1));
    STAMP(r, kProduct);
    // resid -= the product, then x_out = inv(L_out) resid
    reduce_rows<kTranspose>(ds.resid, sum, ds.red, true);
    __syncthreads();
    STAMP(r, kReduced);
    float* x_out = x + static_cast<size_t>(out) * B;
    const int lane = tid & 31, warp = tid >> 5;
    if (!kTranspose) {
      const float4 v = reinterpret_cast<const float4*>(ds.resid)[lane];
      float d[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        d[i] = dot4(reinterpret_cast<const float4*>(ds.inv + (warp + kWarps * i) * B)[lane], v, 0.0f);
      const float xv = warp_sum16(d);
      if (!(lane & 1)) x_out[warp + kWarps * (lane >> 1)] = xv;
    } else {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = warp + kWarps * i;
        axpy4(acc, reinterpret_cast<const float4*>(ds.inv + row * B)[lane], ds.resid[row]);
      }
      reinterpret_cast<float4*>(ds.red + warp * B)[lane] = acc;  // red was last read before the barrier above
      __syncthreads();
      if (tid < B) {
        float xv = 0.0f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) xv += ds.red[q * B + tid];
        x_out[tid] = xv;
      }
    }
    STAMP(r, kApplied);
    __syncthreads();  // x's block is written in full before it is published
    STAMP(r, kBarrier);
    if (tid == 0) {
      AtomicInt(ready[r]).store(1, cuda::memory_order_release);
      STAMP(r, kReleased);
    }
  }
}

int launch(bool transpose, const float* L, const float* y, const float* invs, float* x,
           int* counters, float* partial, int n, int b, int batch, cudaStream_t stream) {
  if (b != B || n < B || n % B != 0 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n / B;
  if (batch * first_item(nb) > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(counters, 0, (1 + 2 * static_cast<size_t>(nb) * batch) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = transpose ? trsv2d_kernel<true> : trsv2d_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      std::min<long long>(static_cast<long long>(sms) * std::max(per_sm, 1), batch * first_item(nb));
  const size_t flags = static_cast<size_t>(nb) * batch;
  const Workspace w{counters, counters + 1, counters + 1 + flags, partial};
  kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(L, y, invs, x, n, batch, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L (n x n, row-major, 16-byte aligned; only its strictly lower block
// triangle is read), y and x (n), invs (n/b, b, b, 16-byte aligned); b must be
// the tile size and n a multiple of it.  Workspace from the caller:
// counters (1 + 2 n/b ints, zeroed here on the stream) and partial
// (n/b (n/b + 1) / 2 * b floats).
extern "C" int gogp_trsv2d_lower(const float* L, const float* y, const float* invs, float* x,
                                 int* counters, float* partial, int n, int b,
                                 cudaStream_t stream) {
  return launch(false, L, y, invs, x, counters, partial, n, b, 1, stream);
}

extern "C" int gogp_trsv2d_lower_t(const float* L, const float* z, const float* invs, float* x,
                                   int* counters, float* partial, int n, int b,
                                   cudaStream_t stream) {
  return launch(true, L, z, invs, x, counters, partial, n, b, 1, stream);
}

// batch solves in one launch: L (batch, n, n), y and x (batch, n), invs
// (batch, n/b, b, b), each contiguous; counters 1 + 2 batch n/b ints and
// partial batch n/b (n/b + 1) / 2 * b floats.
extern "C" int gogp_trsv2d_lower_batched(const float* L, const float* y, const float* invs, float* x,
                                         int* counters, float* partial, int n, int b, int batch,
                                         cudaStream_t stream) {
  return launch(false, L, y, invs, x, counters, partial, n, b, batch, stream);
}

extern "C" int gogp_trsv2d_lower_t_batched(const float* L, const float* z, const float* invs, float* x,
                                           int* counters, float* partial, int n, int b, int batch,
                                           cudaStream_t stream) {
  return launch(true, L, z, invs, x, counters, partial, n, b, batch, stream);
}

// The chain stamps of K4's last launch, for measurement: for each step row r
// < 512, for each ChainStage, the pair (clock64(), %globaltimer in ns) into
// stamps (512 * kChainStages * 2 long longs, device memory), on the stream.
// A build without -DGOGP_TRSV_STAMPS returns cudaErrorNotSupported.
extern "C" int gogp_trsv2d_stamps(long long* stamps, cudaStream_t stream) {
#ifdef GOGP_TRSV_STAMPS
  return static_cast<int>(cudaMemcpyFromSymbolAsync(stamps, chain_stamps, sizeof(chain_stamps), 0,
                                                    cudaMemcpyDeviceToDevice, stream));
#else
  (void)stamps, (void)stream;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
