// K1: batched small-matrix Cholesky -> L^-1, quad, logdet, alpha.
//
// Replaces the Pallas TPU kernel `botorch_tpu/ops/pallas_linalg.py::_qd_pallas`
// (body `_qd_kernel_body`). For each of B symmetric positive-definite
// matrices K (n x n, n <= 64) and vectors r (n) it computes
//   L = chol(K), Linv = L^-1, w = Linv r, quad = w.w, logdet = 2 sum log L_ii,
//   alpha = Linv^T w = K^-1 r,
// and writes quad (B), logdet (B), alpha (B, n) and Linv (B, n, n) unpadded.
// Kinv = Linv^T Linv is formed by the caller, as the JAX package does outside
// its kernel.
//
// What bounds it on an H100: neither bytes nor operations. At the GP sizes
// of the BO loop (n ~ 35, B ~ 2) the work is ~3e4 flops and ~20 KB per call,
// nanoseconds at the card's peak rates; the time is the latency of the
// factorization's n dependent column steps. The TPU kernel put the batch in
// the 128 lanes and unrolled the recurrences; on Hopper the batch is spread
// over blocks instead:
//   * one thread block per matrix, the whole matrix in shared memory
//     (64 x 65 words at most: 16.6 KB in float, 33.3 KB in double), so no
//     step of the factorization touches device memory;
//   * a right-looking Cholesky with two __syncthreads per column: the column
//     is scaled by rsqrt(pivot) (a non-positive pivot gives NaN, as in the
//     TPU kernel; nothing clamps it), then the trailing lower triangle is
//     updated by all threads at once;
//   * L^-1 by forward substitution, one thread per column with no barrier
//     inside; its strict lower part is stored transposed in the strict upper
//     triangle of the same shared buffer, so both factors fit in one matrix;
//   * the leading dimension is padded to 65 so that a thread walking its own
//     column and its neighbours walking theirs hit different banks.
// Making it fast (several matrices per block, warp-level factorization) is
// later work; this kernel is the simple, right one.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kLd = kMaxN + 1;
constexpr int kThreads = 256;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mvn_qd_kernel(const T* __restrict__ K, const T* __restrict__ r,
              T* __restrict__ quad, T* __restrict__ logdet,
              T* __restrict__ alpha, T* __restrict__ linv, int n) {
  __shared__ T A[kMaxN * kLd];
  __shared__ T diag[kMaxN];
  __shared__ T inv_diag[kMaxN];
  __shared__ T rv[kMaxN];
  __shared__ T wv[kMaxN];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* Kb = K + b * nn;

  for (int idx = tid; idx < n * n; idx += nt) {
    A[(idx / n) * kLd + (idx % n)] = Kb[idx];
  }
  for (int i = tid; i < n; i += nt) rv[i] = r[static_cast<size_t>(b) * n + i];
  __syncthreads();

  // ---- Cholesky, outer-product form; L in the lower triangle of A ----
  for (int j = 0; j < n; ++j) {
    const T d = rsqrt_t(A[j * kLd + j]);
    __syncthreads();  // every thread holds the pivot before it is scaled
    for (int i = j + tid; i < n; i += nt) A[i * kLd + j] *= d;
    __syncthreads();
    const int m = n - j - 1;
    for (int t = tid; t < m * m; t += nt) {
      const int i = j + 1 + t / m;
      const int k = j + 1 + t % m;
      if (k <= i) A[i * kLd + k] -= A[i * kLd + j] * A[k * kLd + j];
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt) {
    diag[i] = A[i * kLd + i];
    inv_diag[i] = T(1) / diag[i];
  }
  __syncthreads();

  // ---- Linv by forward substitution: thread c owns column c ----
  // Linv[i][c] for i > c is stored at A[c][i].
  if (tid < n) {
    const int c = tid;
    for (int i = c + 1; i < n; ++i) {
      T acc = A[i * kLd + c] * inv_diag[c];
      for (int k = c + 1; k < i; ++k) acc += A[i * kLd + k] * A[c * kLd + k];
      A[c * kLd + i] = -acc / diag[i];
    }
  }
  __syncthreads();

  // ---- w = Linv r (thread i owns row i) ----
  if (tid < n) {
    const int i = tid;
    T acc = inv_diag[i] * rv[i];
    for (int k = 0; k < i; ++k) acc += A[k * kLd + i] * rv[k];
    wv[i] = acc;
  }
  __syncthreads();

  // ---- alpha = Linv^T w (thread k owns entry k) ----
  if (tid < n) {
    const int k = tid;
    T acc = inv_diag[k] * wv[k];
    for (int i = k + 1; i < n; ++i) acc += A[k * kLd + i] * wv[i];
    alpha[static_cast<size_t>(b) * n + k] = acc;
  }
  if (tid == 0) {
    T q = T(0), ld = T(0);
    for (int i = 0; i < n; ++i) {
      q += wv[i] * wv[i];
      ld += log_t(diag[i]);
    }
    quad[b] = q;
    logdet[b] = T(2) * ld;
  }

  // ---- Linv, dense lower triangular ----
  T* Lb = linv + b * nn;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n;
    const int c = idx % n;
    Lb[idx] = i > c ? A[c * kLd + i] : (i == c ? inv_diag[i] : T(0));
  }
}

template <typename T>
int launch(const T* K, const T* r, T* quad, T* logdet, T* alpha, T* linv,
           int B, int n, void* stream) {
  if (n < 1 || n > kMaxN || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  mvn_qd_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(K, r, quad, logdet, alpha, linv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bt_mvn_qd_f32(const float* K, const float* r, float* quad,
                             float* logdet, float* alpha, float* linv, int B,
                             int n, void* stream) {
  return launch<float>(K, r, quad, logdet, alpha, linv, B, n, stream);
}

extern "C" int bt_mvn_qd_f64(const double* K, const double* r, double* quad,
                             double* logdet, double* alpha, double* linv, int B,
                             int n, void* stream) {
  return launch<double>(K, r, quad, logdet, alpha, linv, B, n, stream);
}
