// K7: the batch of L^-1 for a batch of small SPD covariances, K = L L^T.
//
// Replaces the inner `kernel` / `pallas_linv` of make_fused_value_and_grad in
// gogp_tpu/ops/fused_gp.py: there a masked-reduction Cholesky (chol_value)
// and Gauss-Jordan on [L | I] (lower_inv_value), run over a grid of ~1 MB
// chunks of the chain batch.  The sampler calls it once per leapfrog step
// for the whole chain population; the LML, W = alpha alpha^T - K^-1 and the
// gradient stay outside the kernel, as they stay in XLA on the TPU.
//
// What bounds it here: latency.  At the hyperpriors shapes (64 chains,
// n = 44) the whole batch is 0.5 MB in and out and 1.6 MFLOP, microseconds
// of the card's bandwidth or FMA rate; what costs is the chain of dependent
// steps inside one matrix (n pivots, each a barrier).  The design is the
// simple one: one CTA per matrix, K and L^-1 staged in shared memory (rows
// padded by one word), a right-looking Cholesky column by column with two
// barriers per column, then L^-1 by forward substitution with one thread per
// column of the inverse (a column needs only its own earlier entries, so no
// barrier).  The result is written once.  n <= kMaxN = 128: two 128 x 129
// f32 matrices are 129 KB of the 227 KB a block may use.  A non-positive or
// NaN pivot gives NaN in L^-1, never an early return.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = kMaxN;  // one thread per column of the inverse
constexpr int kMaxSmemBytes = 2 * kMaxN * (kMaxN + 1) * static_cast<int>(sizeof(float));
static_assert(kMaxSmemBytes <= 232448, "two matrices must fit one block's shared memory");

__global__ void __launch_bounds__(kThreads)
    fused_gp_linv_kernel(const float* __restrict__ k, float* __restrict__ linv, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* M = smem;        // n x ld: K; its lower triangle becomes L
  float* X = M + n * ld;  // n x ld: L^-1, lower triangle
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < n * n; idx += kThreads) M[(idx / n) * ld + idx % n] = k[base + idx];
  __syncthreads();

  // Right-looking Cholesky: column j of L from the updated column j of M,
  // then the rank-1 update of the trailing lower triangle.
  for (int j = 0; j < n; ++j) {
    const float piv = M[j * ld + j];
    const float d = piv > 0.0f ? sqrtf(piv) : __int_as_float(0x7fffffff);  // NaN unless positive
    const float rd = 1.0f / d;
    __syncthreads();  // every thread has read the pivot before it is overwritten
    for (int i = j + tid; i < n; i += kThreads) M[i * ld + j] = (i == j) ? d : M[i * ld + j] * rd;
    __syncthreads();
    const int m = n - j - 1;
    for (int idx = tid; idx < m * m; idx += kThreads) {
      const int i = j + 1 + idx / m, c = j + 1 + idx % m;
      if (c <= i) M[i * ld + c] = fmaf(-M[i * ld + j], M[c * ld + j], M[i * ld + c]);
    }
    __syncthreads();
  }

  // Forward substitution, thread c owning column c of X = L^-1:
  //   X[c][c] = 1 / L[c][c],  X[i][c] = -(sum_{k=c}^{i-1} L[i][k] X[k][c]) / L[i][i].
  const int c = tid;
  if (c < n) {
    X[c * ld + c] = 1.0f / M[c * ld + c];
    for (int i = c + 1; i < n; ++i) {
      const float* li = M + i * ld;
      float s = 0.0f;
      for (int kk = c; kk < i; ++kk) s = fmaf(li[kk], X[kk * ld + c], s);
      X[i * ld + c] = -s / li[i];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, col = idx % n;
    linv[base + idx] = (col <= i) ? X[i * ld + col] : 0.0f;
  }
}

}  // namespace

// k and linv: `batch` row-major n x n matrices, contiguous; 1 <= n <= 128.
extern "C" int gogp_fused_gp_linv(const float* k, float* linv, int batch, int n,
                                  cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_gp_linv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 * n * (n + 1) * static_cast<int>(sizeof(float));
  fused_gp_linv_kernel<<<batch, kThreads, smem, stream>>>(k, linv, n);
  return static_cast<int>(cudaGetLastError());
}
