// K4: triangular vector solves over the triangular grid of (b, b) tiles,
//   z = L^{-1} y      (gogp_trsv2d_lower)
//   x = L^{-T} z      (gogp_trsv2d_lower_t)
// with the diagonal tiles applied through their inverses invs[k] (the
// by-product of K1 and K2), one solve spread over many SMs.
//
// Replaces _trsv2d_kernel / pallas_trsv2d_lower and _trsv2d_t_kernel /
// pallas_trsv2d_lower_t in gogp_tpu/ops/cholesky_pallas.py.  Those visit the
// tiles of the lower triangle in a sequential grid, row-major (_tri_kj), one
// tile per step, and carry the solved prefix and the row's running sum in
// VMEM scratch: on the TPU their point is to hold one tile whatever n is.
//
// What bounds it here: bytes.  A solve reads the strictly lower block
// triangle of L once (n(n-b)/2 floats, 533 MB at n = 16384) and the tile
// inverses (n b floats), 2 FLOPs per float read, and one SM pulls only a
// small part of the card's bandwidth (K3, trsv.cu, is that one SM).  So every
// tile is a CTA of its own:
//
//   - the grid has one CTA per tile of the lower triangle, nb(nb+1)/2.  A CTA
//     takes a ticket from an atomic counter; ticket t names tile (r, c),
//     c <= r, in _tri_kj's row-major order, so the diagonal tile is the last
//     ticket of its step row r.  Step row r solves block out = r of x
//     (forward) or out = nb-1-r (transpose, bottom-up).  Column c < r
//     multiplies L[r, c] by x[c] (forward) or L[nb-1-c, nb-1-r]^T by
//     x[nb-1-c] (transpose);
//   - a CTA first loads its tile into registers (64 KB: 16 float4 a thread, a
//     warp reading 512 contiguous bytes of one tile row), then waits: a
//     product for ready[c], the flag of the block of x it multiplies; the
//     diagonal tile, inv(L_out), for done[r] == r, the count of the row's
//     finished products.  The loads are in flight while it waits, so on the
//     chain of diagonal solves a tile costs its arithmetic and the hand-offs,
//     not its trip from memory;
//   - a product writes its b floats to a slot of its own (partial[t]) and
//     counts itself into done[r]; the diagonal tile sums the row's slots in a
//     fixed order (the result does not change from run to run: no float
//     atomics), subtracts them from y, applies inv(L_out), writes x's block
//     and sets ready[r].
//
// Forward progress: a CTA waits only for work of smaller tickets (x's block
// c comes from the last ticket of step row c < r; a row's products come
// before its diagonal ticket).  A ticket is taken only by a CTA that is
// already running, so the CTA with the smallest unfinished ticket runs and
// waits for nothing unfinished: the launch cannot hang, whatever order the
// hardware schedules CTAs in and however few fit on the card at once.
//
// Coherence: x and partial are written and read by other CTAs of the same
// launch.  A writer's threads store, meet at a barrier, and one thread fences
// and publishes with a release at device scope; a reader's thread spins on
// acquire loads, its CTA meets at a barrier, and reads the data through L2
// (__ldcg), never through L1 or the read-only path.  L and invs are only
// read, with an evict-first hint (__ldcs): each float is read once.  The
// counters (ticket, done, ready) are zeroed on the stream before each
// launch.  A NaN in L or y flows into x; no CTA returns early and every flag
// is set, so NaN never hangs the launch.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <climits>

#include "tile_common.cuh"

namespace {

constexpr int B = gogp::kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = B / kWarps;  // tile rows each warp holds
static_assert(B == 4 * 32 && kThreads == 2 * B, "the thread layouts below");

using AtomicInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

struct Workspace {
  int* ticket;     // 1
  int* done;       // nb: finished products of each step row
  int* ready;      // nb: step row r has written its block of x
  float* partial;  // nb(nb+1)/2 * B: one product per ticket
};

// Ticket t -> (r, c) with 0 <= c <= r and t = r(r+1)/2 + c; a float square
// root with integer guards against rounding at row boundaries, as _tri_kj.
__device__ __forceinline__ void tri_rc(int t, int& r, int& c) {
  long long k = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  if ((k + 1) * (k + 2) / 2 <= t) ++k;
  if (k * (k + 1) / 2 > t) --k;
  r = static_cast<int>(k);
  c = static_cast<int>(t - k * (k + 1) / 2);
}

__device__ __forceinline__ void wait_until(int* flag, int value) {
  AtomicInt f(*flag);
  while (f.load(cuda::memory_order_acquire) < value) {
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 u) {
  return fmaf(a.x, u.x, fmaf(a.y, u.y, fmaf(a.z, u.z, a.w * u.w)));
}

template <bool kTranspose>
__global__ void __launch_bounds__(kThreads, 2)
    trsv2d_kernel(const float* __restrict__ L, const float* __restrict__ y,
                  const float* __restrict__ invs, float* x, int n, Workspace w) {
  __shared__ __align__(16) float vs[B];           // the vector the tile multiplies
  __shared__ __align__(16) float red[kWarps][B];  // sums across threads
  __shared__ int ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = n / B;
  if (tid == 0) ticket = atomicAdd(w.ticket, 1);
  __syncthreads();
  const int t = ticket;
  int r, c;
  tri_rc(t, r, c);
  const bool diag = c == r;
  const int out = kTranspose ? nb - 1 - r : r;  // the block of x step row r solves
  const int in = kTranspose ? nb - 1 - c : c;   // the block of x a product reads
  const float* tile;
  size_t ld;
  if (diag) {
    tile = invs + static_cast<size_t>(out) * B * B;
    ld = B;
  } else if (kTranspose) {
    tile = L + static_cast<size_t>(in) * B * n + static_cast<size_t>(out) * B;
    ld = n;
  } else {
    tile = L + static_cast<size_t>(out) * B * n + static_cast<size_t>(in) * B;
    ld = n;
  }

  // Rows warp, warp + kWarps, ... of the tile; lane l holds columns 4l .. 4l+3.
  float4 m[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    m[i] = __ldcs(reinterpret_cast<const float4*>(tile + (warp + kWarps * i) * ld) + lane);

  if (!diag) {
    if (tid == 0) wait_until(w.ready + c, 1);
    __syncthreads();
    if (tid < B) vs[tid] = __ldcg(x + static_cast<size_t>(in) * B + tid);
  } else {
    if (tid == 0) wait_until(w.done + r, r);
    __syncthreads();
    // The row's r products, slots t - r .. t - 1: thread (h, col) sums
    // column col of slots h, h + 2, ... in four chains.
    const int col = tid % B, h = tid / B;
    const float* p = w.partial + static_cast<size_t>(t - r) * B + col;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int q = h;
    for (; q + 6 < r; q += 8) {
      s0 += __ldcg(p + static_cast<size_t>(q) * B);
      s1 += __ldcg(p + static_cast<size_t>(q + 2) * B);
      s2 += __ldcg(p + static_cast<size_t>(q + 4) * B);
      s3 += __ldcg(p + static_cast<size_t>(q + 6) * B);
    }
    for (; q < r; q += 2) s0 += __ldcg(p + static_cast<size_t>(q) * B);
    red[h][col] = (s0 + s1) + (s2 + s3);
    __syncthreads();
    if (tid < B) vs[tid] = y[static_cast<size_t>(out) * B + tid] - (red[0][tid] + red[1][tid]);
  }
  __syncthreads();

  float* dst = diag ? x + static_cast<size_t>(out) * B : w.partial + static_cast<size_t>(t) * B;
  if (!kTranspose) {
    // dst[row] = tile[row, :] . vs, one warp reduction per row, all unrolled
    // so that the sixteen reductions of a warp interleave.
    const float4 v = reinterpret_cast<const float4*>(vs)[lane];
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = gogp::warp_sum(dot4(m[i], v));
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) dst[warp + kWarps * i] = s[i];
    }
  } else {
    // dst[col] = tile[:, col] . vs: each thread sums its rows for its four
    // columns, then the warps' sums meet in shared memory.
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float v = vs[warp + kWarps * i];
      a.x = fmaf(m[i].x, v, a.x);
      a.y = fmaf(m[i].y, v, a.y);
      a.z = fmaf(m[i].z, v, a.z);
      a.w = fmaf(m[i].w, v, a.w);
    }
    reinterpret_cast<float4*>(red[warp])[lane] = a;
    __syncthreads();
    if (tid < B) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][tid];
      dst[tid] = s;
    }
  }

  __syncthreads();  // dst is written in full before it is published
  if (tid == 0) {
    __threadfence();
    if (diag)
      AtomicInt(w.ready[r]).store(1, cuda::memory_order_release);
    else
      AtomicInt(w.done[r]).fetch_add(1, cuda::memory_order_release);
  }
}

int launch(bool transpose, const float* L, const float* y, const float* invs, float* x,
           int* counters, float* partial, int n, int b, cudaStream_t stream) {
  if (b != B || n < B || n % B != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n / B;
  const long long tiles = static_cast<long long>(nb) * (nb + 1) / 2;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counters, 0, (1 + 2 * static_cast<size_t>(nb)) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Workspace w{counters, counters + 1, counters + 1 + nb, partial};
  const dim3 grid(static_cast<unsigned>(tiles));
  if (transpose)
    trsv2d_kernel<true><<<grid, kThreads, 0, stream>>>(L, y, invs, x, n, w);
  else
    trsv2d_kernel<false><<<grid, kThreads, 0, stream>>>(L, y, invs, x, n, w);
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
  return launch(false, L, y, invs, x, counters, partial, n, b, stream);
}

extern "C" int gogp_trsv2d_lower_t(const float* L, const float* z, const float* invs, float* x,
                                   int* counters, float* partial, int n, int b,
                                   cudaStream_t stream) {
  return launch(true, L, z, invs, x, counters, partial, n, b, stream);
}
