// Device helpers shared by the tile kernels (chol_inv_tile.cu, chol_tile.cu,
// tril_inv_tile.cu), the whole-matrix factorization (fused_chol.cu) and the
// small-matrix inverses (fused_gp.cu); the streaming solves (trsv.cu,
// trsv2d.cu) take the constants and warp_sum.  Tiles live in shared memory
// row-major with rows padded to B + 4 floats (kTileLd), so that they move as
// float4 and every access reads or writes rows, never a column.
#pragma once

#include <cuda_runtime.h>

namespace gogp {

// Most dynamic shared memory one block may use on Hopper (227 KB).
constexpr int kMaxSharedBytes = 232448;
// The one tile size K2 and K5 are built for (DEFAULT_BLOCK in
// gogp_torch/ops/cholesky_blocked.py): a tile and its inverse fit one
// block's shared memory.  The helpers below are written for any multiple of
// 32.
constexpr int kTile = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// Stage stamps of the tile body, for measurement only.  Built with
// -DGOGP_TILE_STAMPS (chip_smoke.py --phases stamps), thread 0 records
// (stage * 8 + panel, clock64()) pairs as it passes each stage; each
// translation unit has its own buffer, and chol_inv_tile.cu's entry
// gogp_chol_inv_tile_stamps copies K2's out.  The normal build records
// nothing.
enum TileStage {
  kStampStart, kStampLoad, kStampChol, kStampDiag, kStampPanel, kStampUpdate, kStampInverse, kStampStore,
};
constexpr int kMaxStamps = 64;
#ifdef GOGP_TILE_STAMPS
static __device__ long long tile_stamps[2 * kMaxStamps];
static __device__ int tile_stamp_count;
__device__ __forceinline__ void stamp(int stage, int panel) {
  if (threadIdx.x != 0) return;
  if (stage == kStampStart) tile_stamp_count = 0;
  const int i = tile_stamp_count;
  if (i < kMaxStamps) {
    tile_stamps[2 * i] = stage * 8 + panel;
    tile_stamps[2 * i + 1] = clock64();
    tile_stamp_count = i + 1;
  }
}
#define GOGP_STAMP(stage, panel) ::gogp::stamp(::gogp::stage, panel)
#define GOGP_STAMP_SYNC() __syncthreads()
#else
#define GOGP_STAMP(stage, panel) ((void)0)
#define GOGP_STAMP_SYNC() ((void)0)
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// The tile body: the Cholesky factor L of one B x B SPD tile and V = inv(L),
// by one block of kTileThreads threads with the tile in shared memory.  It is
// the serial core of K2 (chol_inv_tile.cu), K6 (chol_tile.cu, L alone), K7's
// class 64 < n <= 128 (fused_gp.cu) and K1's diagonal step (fused_chol.cu).
//
// What bounds it: one SM's latency.  A 128-tile is 0.7 MFLOP for the factor
// and as much for the inverse, a few microseconds of one SM's FMA rate if
// every lane were busy; the rest is the chain of 128 dependent pivots and
// the barriers between the steps that feed them.  So:
//
//   - the critical path is the four 32 x 32 diagonal blocks and, between
//     them, one 32-row forward substitution and one rank-32 update of the
//     next 32 columns (look-ahead): while warp 0 factors diagonal block p,
//     the warps on the other three schedulers apply panel p - 1's update to
//     the columns beyond block p and form the product T of block row p of
//     inv(L) (tile_inv_partial);
//   - a diagonal block is one warp with its rows in registers (tile_diag),
//     8 columns at a time: every lane factors the 8 x 8 diagonal piece
//     itself, so lanes meet twice per 8 pivots, not once per pivot;
//   - everything that divides by L_pp is forward substitution against it,
//     as the JAX twin's tile kernel eliminates within its rank-32 slabs and
//     as K5 forms inv(L): a lane solves L_pp x = b for the 32 rows of one
//     right-hand side (diag_solve_column, rows of L read as float4
//     broadcasts), b a row of the panel below the block (x is L's row), a
//     column of -T (x is a column of V_pq = -inv(L_pp) T_q, T_q = sum_{k<p}
//     L_pk V_kq) or of the identity (x is a column of V_pp); a warp takes
//     32 of them, and the (at most B/32) warps of a block column run side
//     by side, one to each scheduler.  An earlier body multiplied by the
//     explicit inverse instead (the panel by V_pp^T, V_pq = -V_pp T_q): on
//     rbf tiles with jitter 1e-5 it gave factors off by up to 5e10 of a
//     column's scale, or NaN, where cuSOLVER's f32 factor and the twin's
//     were finite;
//   - the products (the rank-32 updates, T) are register tiles of 2 x 4 or
//     4 x 4 outputs a thread, their operands read as float4 rows from shared
//     memory: rows of the tile (padded to B + 4 floats, so rows start
//     16-byte aligned) or of the panel's transpose PT, which the panel's
//     solves write for that;
//   - three block barriers per 32 columns; the tile moves between global and
//     shared memory as float4 where the leading dimension allows, every load
//     in flight at once;
//   - one call site in the body for every substitution (tile_solve): with
//     a copy of it inlined for each kind of right-hand side, K2 alone was
//     as fast, but K1 and the stepwise driver, where the body runs between
//     other work, lost 3-8%, and K2 used 126 registers (110 now).  K1's
//     slabs (fused_chol.cu, run_slab) call diag_solve_column once more,
//     outside the body.
// On an NVIDIA H100 80GB HBM3 at 700 W, K2 takes 0.0228 ms a tile
// (chip_smoke's kernels phase), K1 0.6235 ms at n = 1536 and 1.858 at 4096
// (tests/panel_times.py; 0.565 and 1.744 when its slabs multiplied by
// inv(L_kk)).
// ---------------------------------------------------------------------------

// The block size the tile body is written for.
constexpr int kTileThreads = 512;

// Leading dimensions of the body's matrices in shared memory.  Every access
// reads or writes rows (lanes along a row, or one row broadcast to a warp),
// never a column, so the padding only aligns rows to 16 bytes.
template <int B>
constexpr int kTileLd = B + 4;  // M (becomes L), V = inv(L), PT (32 x B)
template <int B>
constexpr int kTLd = B - 32 + 4;  // T (32 x (B - 32)), the partial products of inv(L)'s block rows

// Offsets, in floats, of the body's arrays in its shared memory.
template <int B>
constexpr int kTileV = B * kTileLd<B>;
template <int B>
constexpr int kTilePT = 2 * B * kTileLd<B>;
template <int B>
constexpr int kTileT = kTilePT<B> + 32 * kTileLd<B>;
template <int B>
constexpr int kTileDinv = kTileT<B> + 32 * kTLd<B>;  // 1 / diag(L), B floats
template <int B>
constexpr int kTileBcast = kTileDinv<B> + B;  // 64 + 32 x 8 floats: tile_diag's broadcasts
// Shared memory the tile body needs, in floats.
template <int B>
constexpr int kTileSmemFloats = kTileBcast<B> + 64 + 32 * 8;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
// Component e of v; e is a constant once the loops around it unroll.
__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// acc[a][b] += sum_{k0 <= k < k1} A[a * lda + k] Bm[k * ldb + b] for a < RA,
// b < 4: a register tile, A's rows read as float4 (each a broadcast where a
// warp shares them), Bm's rows as float4.  k0, k1, lda, ldb and both
// pointers are multiples of 4 floats.
template <int RA>
__device__ __forceinline__ void mma_rows(float (&acc)[RA][4], const float* A, int lda, const float* Bm,
                                         int ldb, int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; k += 4) {
    float4 av[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = ld4(A + a * lda + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 bv = ld4(Bm + (k + e) * ldb);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float x = at(av[a], e);
        acc[a][0] = fmaf(x, bv.x, acc[a][0]);
        acc[a][1] = fmaf(x, bv.y, acc[a][1]);
        acc[a][2] = fmaf(x, bv.z, acc[a][2]);
        acc[a][3] = fmaf(x, bv.w, acc[a][3]);
      }
    }
  }
}

// The rank-32 update of the 4 x 4 block of M at (i0, k0) by the panel:
// M[i][k] -= sum_s P[i][s] P[k][s], P read from its transpose PT (32 rows of
// ld floats, indexed by the row of M).
__device__ __forceinline__ void tile_update(float* M, const float* PT, int ld, int i0, int k0) {
  float acc[4][4] = {};
#pragma unroll 8
  for (int s = 0; s < 32; ++s) {
    const float4 pa = ld4(PT + s * ld + i0), pb = ld4(PT + s * ld + k0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x = at(pa, a);
      acc[a][0] = fmaf(x, pb.x, acc[a][0]);
      acc[a][1] = fmaf(x, pb.y, acc[a][1]);
      acc[a][2] = fmaf(x, pb.z, acc[a][2]);
      acc[a][3] = fmaf(x, pb.w, acc[a][3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float4 m = ld4(M + (i0 + a) * ld + k0);
    m.x -= acc[a][0];
    m.y -= acc[a][1];
    m.z -= acc[a][2];
    m.w -= acc[a][3];
    st4(M + (i0 + a) * ld + k0, m);
  }
}

// Column `lane` of X = inv(L_cc) B, L_cc the 32 x 32 lower-triangular block
// at (c, c) of the matrix whose rows (ld floats each, 16-byte aligned) start
// at M, by one warp: lane j forms x_i = (b_ij - sum_{k<i} L[i][k] x_k) /
// L[i][i] for every i, 8 rows at a time: the 8 rows' sums over the entries
// solved before them run as independent chains, then an 8 x 8 forward
// substitution; rows of L are read as float4 broadcasts.  B is the identity
// (kIdentity: X = inv(L_cc), 0 above the diagonal) or the lane's column b_i
// = x[i] on entry.  dinv[c + i] holds 1 / L[c + i][c + i] (16-byte aligned).
template <int ld, bool kIdentity = true>
__device__ __forceinline__ void diag_solve_column(const float* M, const float* dinv, int c, float (&x)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 8) {
    // rows i0 .. i0 + 7: the right-hand side less the rows' products with
    // the solved entries above (8 independent sums), then an 8 x 8 forward
    // substitution, column by column
    const float4 d0 = ld4(dinv + c + i0), d1 = ld4(dinv + c + i0 + 4);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    float sum[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float* li = M + (c + i0 + t) * ld + c;
      float acc = kIdentity ? (i0 + t == lane ? 1.0f : 0.0f) : x[i0 + t];
#pragma unroll
      for (int q = 0; 4 * q < i0; ++q) {
        const float4 l4 = ld4(li + 4 * q);
        acc = fmaf(-l4.x, x[4 * q], acc);
        acc = fmaf(-l4.y, x[4 * q + 1], acc);
        acc = fmaf(-l4.z, x[4 * q + 2], acc);
        acc = fmaf(-l4.w, x[4 * q + 3], acc);
      }
      sum[t] = acc;
    }
    float l8[8][8];
#pragma unroll
    for (int t = 1; t < 8; ++t) {
      const float4 v0 = ld4(M + (c + i0 + t) * ld + c + i0), v1 = ld4(M + (c + i0 + t) * ld + c + i0 + 4);
      l8[t][0] = v0.x, l8[t][1] = v0.y, l8[t][2] = v0.z, l8[t][3] = v0.w;
      l8[t][4] = v1.x, l8[t][5] = v1.y, l8[t][6] = v1.z, l8[t][7] = v1.w;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      x[i0 + t] = sum[t] * dv[t];
#pragma unroll
      for (int u = t + 1; u < 8; ++u) sum[u] = fmaf(-l8[u][t], x[i0 + t], sum[u]);
    }
  }
}

// Diagonal block p (columns c = 32 p ...) of the body, by one warp.
//
// Cholesky: lane l holds row c + l in registers, and the 32 columns go 8 at a
// time.  Every lane takes the 8 x 8 diagonal block (a broadcast through
// shared memory) and factors it itself, in registers: 8 pivots, each one
// rsqrt and a few FMAs on the chain, with no communication between lanes.
// Each lane then solves its own 8 entries of those columns against the
// block's factor, and one more broadcast (its 8 entries as two float4) gives
// every lane the rows it needs for the rank-8 update of its entries right
// of them.  A pivot per lane-to-lane hand-off (a shuffle, or a store, a
// __syncwarp and a load) cost about 300 cycles a pivot on an H100; here
// there are two hand-offs per 8 pivots.  A non-positive pivot gives NaN
// (rsqrt of a negative number, or 0 * inf), which flows into everything
// after it.  Entries above the diagonal are never read, and the ones this
// leaves in the registers and in M are not L's.
//
// It writes L's rows into M and 1 / L[i][i] into dinv.
template <int B>
__device__ __forceinline__ void tile_diag(float* smem, int p) {
  constexpr int ld = kTileLd<B>;
  const int lane = threadIdx.x & 31, c = 32 * p;
  float* row = smem + (c + lane) * ld + c;
  float a[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = ld4(row + 4 * q);
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
  float rs_own = 0.0f;              // 1 / L[c + lane][c + lane]
  float* G = smem + kTileBcast<B>;  // the 8 x 8 diagonal block, 8 floats a row
  float* P = G + 64;                // the 8 new columns of L, 8 floats a row
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 8) {
    // 1. Every lane takes the 8 x 8 block at (j0, j0) and factors it itself.
    if (lane >= j0 && lane < j0 + 8) {
      st4(G + 8 * (lane - j0), make_float4(a[j0], a[j0 + 1], a[j0 + 2], a[j0 + 3]));
      st4(G + 8 * (lane - j0) + 4, make_float4(a[j0 + 4], a[j0 + 5], a[j0 + 6], a[j0 + 7]));
    }
    __syncwarp();
    float g[8][8], rs[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 v0 = ld4(G + 8 * r), v1 = ld4(G + 8 * r + 4);
      g[r][0] = v0.x, g[r][1] = v0.y, g[r][2] = v0.z, g[r][3] = v0.w;
      g[r][4] = v1.x, g[r][5] = v1.y, g[r][6] = v1.z, g[r][7] = v1.w;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      rs[s] = rsqrtf(g[s][s]);  // NaN for a negative pivot, inf for 0 (and then 0 * inf)
#pragma unroll
      for (int r = s; r < 8; ++r) g[r][s] *= rs[s];
#pragma unroll
      for (int r = s + 1; r < 8; ++r)
#pragma unroll
        for (int k = s + 1; k <= r; ++k) g[r][k] = fmaf(-g[r][s], g[k][s], g[r][k]);
    }
    // 2. Each lane's 8 entries of these columns: its row of the block, or
    //    for rows below it the panel, row solve against the block's factor.
    float pv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float acc = a[j0 + t];
#pragma unroll
      for (int u = 0; u < t; ++u) acc = fmaf(-pv[u], g[t][u], acc);
      pv[t] = acc * rs[t];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (lane == j0 + r) {
        rs_own = rs[r];
#pragma unroll
        for (int t = 0; t < 8; ++t) pv[t] = t <= r ? g[r][t] : 0.0f;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) a[j0 + t] = pv[t];
    if (j0 == 24) break;
    // 3. The rank-8 update of every lane's entries right of them, the other
    //    lanes' new entries read back as float4 broadcasts.
    st4(P + 8 * lane, make_float4(pv[0], pv[1], pv[2], pv[3]));
    st4(P + 8 * lane + 4, make_float4(pv[4], pv[5], pv[6], pv[7]));
    __syncwarp();
#pragma unroll
    for (int k = j0 + 8; k < 32; ++k) {
      const float4 q0 = ld4(P + 8 * k), q1 = ld4(P + 8 * k + 4);
      float x = a[k];
      x = fmaf(-pv[0], q0.x, x);
      x = fmaf(-pv[1], q0.y, x);
      x = fmaf(-pv[2], q0.z, x);
      x = fmaf(-pv[3], q0.w, x);
      x = fmaf(-pv[4], q1.x, x);
      x = fmaf(-pv[5], q1.y, x);
      x = fmaf(-pv[6], q1.z, x);
      x = fmaf(-pv[7], q1.w, x);
      a[k] = x;
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) st4(row + 4 * q, make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]));
  smem[kTileDinv<B> + c + lane] = rs_own;
  GOGP_STAMP(kStampChol, p);
}

// Unit u of T = L[c:c+32, :c] V[:c, :c] (block row p of inv(L) is -inv(L_pp) T),
// 2 x 4 outputs: rows r0 = 2 (u / (c/4)), columns j0 = 4 (u % (c/4)).  V is
// zero above its diagonal, so the sum starts at k = j0.
template <int B>
__device__ __forceinline__ void tile_inv_partial(float* smem, int c, int u) {
  constexpr int ld = kTileLd<B>;
  const int r0 = 2 * (u / (c / 4)), j0 = 4 * (u % (c / 4));
  float acc[2][4] = {};
  mma_rows<2>(acc, smem + (c + r0) * ld, ld, smem + kTileV<B> + j0, ld, j0, c);
  float* t = smem + kTileT<B> + r0 * kTLd<B> + j0;
  st4(t, make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]));
  st4(t + kTLd<B>, make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]));
}

// Solve `job` of block column p (c = 32 p), by one warp: lane l solves
// L_pp x = b by forward substitution against L_pp (diag_solve_column), L_pp
// and 1 / diag(L) from tile_diag.  The jobs, in this order:
//   - the panel below block p, 32 rows a job: b is row r of the panel, and x,
//     that row of L, goes into M and, transposed, into PT;
//   - with kInverse, block row p of V below the diagonal, 32 columns a job:
//     b is column j of -T (tile_inv_partial), x column j of V_pq = -inv(L_pp)
//     T_q;
//   - with kInverse, V_pp itself: b is column l of the identity.
// One call site for every kind keeps one copy of the substitution's code.
template <int B, bool kInverse>
__device__ __forceinline__ void tile_solve(float* smem, int p, int job) {
  constexpr int ld = kTileLd<B>;
  const int lane = threadIdx.x & 31, c = 32 * p, panel_jobs = (B - c - 32) / 32;
  float x[32];
  float* row = smem + (c + 32 + 32 * job + lane) * ld + c;  // the panel's row, for a panel job
  if (job < panel_jobs) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = ld4(row + 4 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else if (job < panel_jobs + p) {
    const float* t = smem + kTileT<B> + 32 * (job - panel_jobs) + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = -t[i * kTLd<B>];
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = i == lane ? 1.0f : 0.0f;
  }
  diag_solve_column<ld, false>(smem, smem + kTileDinv<B>, c, x);
  if (job < panel_jobs) {
#pragma unroll
    for (int q = 0; q < 8; ++q) st4(row + 4 * q, make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
    float* pt = smem + kTilePT<B> + c + 32 + 32 * job + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) pt[i * ld] = x[i];
  } else if (kInverse) {
    const int col = job < panel_jobs + p ? 32 * (job - panel_jobs) : c;
    float* v = smem + kTileV<B> + c * ld + col + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i * ld] = x[i];
  }
}

// The factorization at the heart of K2, on a tile that already lies in shared
// memory: M (B x kTileLd<B>, row-major, at smem) holds an SPD tile, of which
// only the lower triangle is read, and its lower triangle becomes L; V (at
// smem + kTileV<B>) gets inv(L), lower triangle, and dinv (at smem +
// kTileDinv<B>) 1 / diag(L).  One block of kTileThreads threads with
// kTileSmemFloats<B> floats at smem; the caller synchronises the block after
// filling M, and this function ends with a barrier.  With kInverse false
// only L and dinv are formed.  A non-positive or NaN pivot gives NaN; it
// never returns early.
//
// Per 32-wide block column p (c = 32 p), three barriers:
//   A. warp 0 factors diagonal block p (tile_diag); the 12 warps on the
//      other three schedulers apply panel p - 1's update to the columns
//      right of block p, then form T for block row p of V (warps 4, 8 and
//      12 wait: on warp 0's scheduler they slowed it by half);
//   B. the solves against L_pp (tile_solve), one a warp, side by side on
//      warps 0 .. B/32 - 1, one to each scheduler: the panel's rows, block
//      row p of V below the diagonal and V_pp;
//   D. the update of the next 32 columns (4 x 4 a thread), which diagonal
//      block p + 1 and panel p + 1 need.
// The last block column has no panel and no step D.
template <int B, bool kInverse = true>
__device__ __forceinline__ void chol_inv_tile_factor(float* smem) {
  constexpr int ld = kTileLd<B>, NP = B / 32;
  float* M = smem;
  float* PT = smem + kTilePT<B>;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int p = 0; p < NP; ++p) {
    const int c = 32 * p;
    if (warp == 0) {
      tile_diag<B>(smem, p);
    } else if (warp % 4 != 0) {
      // The warps that share no scheduler with warp 0 (warps go to an SM's
      // four schedulers by warp % 4): 12 warps, 384 threads.
      const int w4 = (B - c - 32) / 4;  // panel p - 1's update right of block p: w4 x w4 units
      const int rest = p > 0 ? w4 * w4 : 0, partial = kInverse && p > 0 ? 4 * c : 0;
      for (int u = 32 * (warp - warp / 4 - 1) + (tid & 31); u < rest + partial; u += kTileThreads * 3 / 4) {
        if (u >= rest) {
          tile_inv_partial<B>(smem, c, u - rest);
        } else if (u / w4 >= u % w4) {  // units wholly above the diagonal are skipped
          tile_update(M, PT, ld, c + 32 + 4 * (u / w4), c + 32 + 4 * (u % w4));
        }
      }
    }
    __syncthreads();
    GOGP_STAMP(kStampDiag, p);

    const int jobs = (B - c - 32) / 32 + (kInverse ? p + 1 : 0);
    if (jobs == 0) break;  // K6's last block column
    if (warp < jobs) tile_solve<B, kInverse>(smem, p, warp);
    __syncthreads();
    GOGP_STAMP(kStampPanel, p);
    if (p == NP - 1) break;

    if (tid < (B - c - 32) / 4 * 8 && (tid >> 3) >= (tid & 7))
      tile_update(M, PT, ld, c + 32 + 4 * (tid >> 3), c + 32 + 4 * (tid & 7));
    __syncthreads();
    GOGP_STAMP(kStampUpdate, p);
  }
}

// One B x B SPD tile's Cholesky factor L and its inverse V = inv(L), by one
// block of kTileThreads threads with kTileSmemFloats<B> floats of shared
// memory at smem (16-byte aligned): the tile is staged into shared memory,
// factored by chol_inv_tile_factor and written out.  With kInverse false it
// computes L alone (K6) and v_out is not written.  Tiles are row-major with
// leading dimensions lda, ldl, ldv, moved as float4 where the leading
// dimensions and pointers allow; l_out may alias a.  a is read through L2
// (ld.global.cg), never through L1 or the read-only path, so the tile may
// have been written by other blocks of the same launch before a grid-wide
// barrier or an acquire.
template <int B, bool kInverse = true>
__device__ __forceinline__ void chol_inv_tile_body(const float* a, int lda, float* l_out,
                                                   int ldl, float* v_out, int ldv,
                                                   float* smem) {
  constexpr int ld = kTileLd<B>, Q = B / 4, T = kTileThreads;
  constexpr int kVec = (B * Q + T - 1) / T, kScalar = (B * B + T - 1) / T;
  float* M = smem;
  const float* V = smem + kTileV<B>;
  const int tid = threadIdx.x;
  const auto aligned = [](const void* ptr) { return (reinterpret_cast<size_t>(ptr) & 15) == 0; };

  GOGP_STAMP(kStampStart, 0);
  if (lda % 4 == 0 && aligned(a)) {
    float4 v[kVec];
#pragma unroll
    for (int it = 0; it < kVec; ++it) {
      const int q = tid + it * T;
      if (q < B * Q) v[it] = __ldcg(reinterpret_cast<const float4*>(a + (q / Q) * lda) + q % Q);
    }
#pragma unroll
    for (int it = 0; it < kVec; ++it) {
      const int q = tid + it * T;
      if (q < B * Q) st4(M + (q / Q) * ld + 4 * (q % Q), v[it]);
    }
  } else {
    float v[kScalar];
#pragma unroll
    for (int it = 0; it < kScalar; ++it) {
      const int q = tid + it * T;
      if (q < B * B) v[it] = __ldcg(a + (q / B) * lda + q % B);
    }
#pragma unroll
    for (int it = 0; it < kScalar; ++it) {
      const int q = tid + it * T;
      if (q < B * B) M[(q / B) * ld + q % B] = v[it];
    }
  }
  __syncthreads();  // a is read in full before l_out, which may alias it, is written
  GOGP_STAMP(kStampLoad, 0);

  chol_inv_tile_factor<B, kInverse>(smem);

  if (ldl % 4 == 0 && aligned(l_out) && (!kInverse || (ldv % 4 == 0 && aligned(v_out)))) {
    for (int q = tid; q < B * Q; q += T) {
      const int i = q / Q, k = 4 * (q % Q);
      float4 m = ld4(M + i * ld + k);
      st4(l_out + i * ldl + k, make_float4(k <= i ? m.x : 0.0f, k + 1 <= i ? m.y : 0.0f,
                                           k + 2 <= i ? m.z : 0.0f, k + 3 <= i ? m.w : 0.0f));
      if (kInverse) {
        m = ld4(V + i * ld + k);
        st4(v_out + i * ldv + k, make_float4(k <= i ? m.x : 0.0f, k + 1 <= i ? m.y : 0.0f,
                                             k + 2 <= i ? m.z : 0.0f, k + 3 <= i ? m.w : 0.0f));
      }
    }
  } else {
    for (int q = tid; q < B * B; q += T) {
      const int i = q / B, k = q % B;
      l_out[i * ldl + k] = k <= i ? M[i * ld + k] : 0.0f;
      if (kInverse) v_out[i * ldv + k] = k <= i ? V[i * ld + k] : 0.0f;
    }
  }
  GOGP_STAMP_SYNC();
  GOGP_STAMP(kStampStore, 0);
}

}  // namespace gogp
