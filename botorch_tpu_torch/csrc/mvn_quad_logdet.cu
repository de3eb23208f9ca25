// K1: batched small-matrix Cholesky -> quad, logdet, alpha and K^-1.
//
// Replaces the Pallas TPU kernel `botorch_tpu/ops/pallas_linalg.py::_qd_pallas`
// (body `_qd_kernel_body`, plus the Kinv product that function forms after
// the kernel). For each of B symmetric positive-definite matrices K
// (n x n, n <= 64) and vectors r (n) it computes
//   L = chol(K), X = L^-1, w = X r, quad = w.w, logdet = 2 sum log L_ii,
//   alpha = X^T w = K^-1 r, Kinv = X^T X = K^-1,
// and writes quad (B), logdet (B), alpha (B, n) and Kinv (B, n, n).
//
// What bounds it on an H100: neither bytes nor operations. At the GP sizes
// of the BO loop (n ~ 35, B ~ 2) a call moves ~20 KB and does ~1e5 flops,
// nanoseconds at the card's peak rates; the time is the latency of the
// factorization's n dependent column steps, of the n dependent row steps
// of X, and of the instructions one thread issues along them: a warp alone
// on its scheduler hides no latency (11-13 cycles per element of a shared-
// memory row update on one H100 80GB HBM3 at 700 W, `tools/warp_costs.py`).
// The design keeps each chain short and each thread's share small:
//   * a block of 32 threads (n <= 32) or 64 threads (n > 32) per matrix,
//     thread t owning row t of L and column t of X, so no thread carries
//     two rows. A block synchronizes with __syncwarp (32 threads) or
//     __syncthreads (64). An SM holds up to 32 such blocks at once, so a
//     batch larger than the SM count fills the SMs without packing
//     matrices into one block;
//   * everything lives in shared memory: L and X^T as (n + 1) x ld arrays
//     (row n is scratch for the threads past n), the column being
//     eliminated, r, w and the pivots. ld >= n + 15 and ld * size is 16 bytes
//     times an odd number, so that 16-byte loads of the threads' own rows
//     fall in distinct banks and a chunk of 16 columns stays inside a row;
//   * right-looking Cholesky: per column j one group barrier. The owners
//     scale column j and publish it in a double-buffered vector (zeros at
//     and above j), and the owner of row j + 1 publishes the next pivot;
//     each thread then updates its whole row with 16-byte loads and stores,
//     reading the column by broadcast (16 columns a chunk);
//   * X = L^-1 by rows inside the same loop, thread t across column t: once
//     column j is done, row j of X is one dot product per thread of L's
//     row j (broadcast) with the thread's own row of X^T, in chunks of 16
//     with four accumulators, interleaved with the update's chunks. Entries
//     of X^T not yet written are zero, so no chunk needs a mask, and no
//     thread reads what another thread writes into X^T;
//   * quad and logdet by butterfly shuffles and, for two warps, one
//     exchange in shared memory (no atomics: the result does not depend on
//     scheduling);
//   * Kinv four rows at a time (two in float64), thread t across column t,
//     each entry the sum over k of X_ka X_kt from a start below both
//     indices that is a multiple of 4 (the terms below max(a, t) are exact
//     zeros), even and odd k apart, then added: entry (a, t) and entry
//     (t, a) take the same products in the same order, so Kinv is exactly
//     symmetric; stores are coalesced;
//   * nested row/column loops everywhere: no integer division in a loop.
// A non-positive pivot gives NaN (rsqrt of it), as in the TPU kernel; nothing
// clamps it, because the fit drops non-finite restarts.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxThreads = 64;
constexpr int kChunk = 16;  // columns per chunk of the n^2/2 loops
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Consecutive values through 16-byte shared-memory accesses; p is 16-byte
// aligned (row starts are, and chunks start at multiples of 4).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}
__device__ __forceinline__ void load8(const double* p, double* v) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 a = reinterpret_cast<const double2*>(p)[h];
    v[2 * h] = a.x;
    v[2 * h + 1] = a.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(double* p, const double* v) {
#pragma unroll
  for (int h = 0; h < 4; ++h) reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
}
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, T* v) {
  load8(p, v);
  load8(p + 8, v + 8);
}
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const T* v) {
  store8(p, v);
  store8(p + 8, v + 8);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Synchronizes the TPM threads of one matrix, its whole block.
template <int TPM>
__device__ __forceinline__ void group_sync() {
  if (TPM == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <typename T, int TPM>
__global__ void __launch_bounds__(kMaxThreads)
mvn_qd_kernel(const T* __restrict__ K, const T* __restrict__ r,
              T* __restrict__ quad, T* __restrict__ logdet,
              T* __restrict__ alpha, T* __restrict__ kinv, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;  // the row of L and column of X this thread owns
  const long long b = blockIdx.x;  // its matrix

  // per matrix: L and XT ((n + 1) x ld each), two column buffers, r, w,
  // the pivots and the cross-warp partial sums, each ld long
  const int rows = (n + 1) * ld;
  T* L = reinterpret_cast<T*>(smem_raw);
  T* XT = L + rows;
  T* col = XT + rows;
  T* rv = col + 2 * ld;
  T* wv = rv + ld;
  T* pv = wv + ld;
  T* part = pv + ld;
  const bool own = t < n;
  const int c = own ? t : n;  // own row/column, or the scratch row / zero padding column
  T* Lr = L + c * ld;
  T* Xr = XT + c * ld;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* Kb = K + b * nn;

  // ---- K -> L, kChunk rows of loads in flight at a time. The first rows'
  // loads are issued before L, XT and the column buffers are zeroed
  // (16-byte stores), so the zeroing hides their latency; L's padding
  // columns stay zero, XT starts zero ----
  T kv[kChunk];
#pragma unroll
  for (int q = 0; q < kChunk; ++q) kv[q] = (q < n && own) ? Kb[q * n + t] : T(0);
  {
    const int n16 = (2 * rows + 2 * ld) * static_cast<int>(sizeof(T)) / 16;
    float4* z = reinterpret_cast<float4*>(L);
    for (int i = t; i < n16; i += TPM) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = t; i < ld; i += TPM) wv[i] = T(0);
    if (own) rv[t] = r[b * n + t];
    if (t == 0) pv[0] = kv[0];
  }
  group_sync<TPM>();
  for (int g0 = 0; g0 < n; g0 += kChunk) {
    if (g0 > 0) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) kv[q] = (g0 + q < n && own) ? Kb[(g0 + q) * n + t] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (g0 + q < n && own) L[(g0 + q) * ld + t] = kv[q];
    }
  }
  group_sync<TPM>();

  // ---- Cholesky, right-looking, and X = L^-1 row by row; one group
  // barrier per column ----
  // The owner of row j + 1 publishes the next pivot before the barrier (its
  // diagonal after this step's update, computed as the update computes it),
  // and the column buffers alternate, so nothing else has to wait. After
  // the barrier row j of L is final left of the diagonal, so each thread
  // also forms X_jt = -(sum_{k<j} L_jk X_kt) / L_jj into XT[t][j]. Its chunks
  // run past k = j: XT[t][k] is still zero there and L holds finite values,
  // so those terms vanish and no chunk needs a mask. The update's and the
  // dot product's chunks are interleaved: two independent streams of loads.
  for (int j = 0; j < n; ++j) {
    const T d = rsqrt_t(pv[j]);
    const T l = t >= j ? Lr[j] * d : T(0);
    T* cj = col + (j & 1) * ld;
    if (own) cj[t] = t > j ? l : T(0);
    if (t == j + 1) pv[j + 1] = fma_t(-l, l, Lr[j + 1]);
    group_sync<TPM>();  // column j and the next pivot published
    Lr[j] = l;
    const T* Lj = L + j * ld;
    const int u0 = (j + 1) & ~3;  // the update's first chunk
    const int nu = (n - u0 + kChunk - 1) / kChunk;
    const int nx = (j + kChunk - 1) / kChunk;
    T s[4] = {T(0), T(0), T(0), T(0)};
    for (int m = 0; m < nu || m < nx; ++m) {
      if (m < nu) {
        const int k0 = u0 + m * kChunk;
        T v[kChunk], cv[kChunk];
        load_chunk(Lr + k0, v);
        load_chunk(cj + k0, cv);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) v[u] = fma_t(-l, cv[u], v[u]);
        store_chunk(Lr + k0, v);
      }
      if (m < nx) {
        const int k0 = m * kChunk;
        T lv[kChunk], xv[kChunk];
        load_chunk(Lj + k0, lv);
        load_chunk(Xr + k0, xv);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) s[u & 3] = fma_t(lv[u], xv[u], s[u & 3]);
      }
    }
    Xr[j] = t < j ? -((s[0] + s[1]) + (s[2] + s[3])) * d : (t == j ? d : T(0));
  }
  const T logs = own ? log_t(Lr[t]) : T(0);
  group_sync<TPM>();  // XT is read across threads from here on

  // ---- w = X r, quad and logdet ----
  T w = T(0);
  for (int k = 0; k < n; ++k) w = fma_t(XT[k * ld + c], rv[k], w);
  if (own) wv[t] = w;
  T q = warp_sum(own ? w * w : T(0));
  T ldt = warp_sum(logs);
  if (TPM == 64) {
    if ((t & 31) == 0) {
      part[t >> 5] = q;
      part[2 + (t >> 5)] = ldt;
    }
  }
  group_sync<TPM>();
  if (TPM == 64) {
    q = part[0] + part[1];
    ldt = part[2] + part[3];
  }

  // ---- alpha = X^T w; thread t sums column t of X against w ----
  {
    T e = T(0), o = T(0);
    for (int k0 = 0; k0 < n; k0 += kChunk) {
      T xv[kChunk], wk[kChunk];
      load_chunk(Xr + k0, xv);
      load_chunk(wv + k0, wk);
#pragma unroll
      for (int u = 0; u < kChunk; u += 2) {
        e = fma_t(xv[u], wk[u], e);
        o = fma_t(xv[u + 1], wk[u + 1], o);
      }
    }
    if (own) alpha[b * n + t] = e + o;
  }
  if (t == 0) {
    quad[b] = q;
    logdet[b] = T(2) * ldt;
  }

  // ---- Kinv = X^T X, R rows a.. at a time; thread t writes entries (a, t) ----
  constexpr int R = sizeof(T) == 4 ? 4 : 2;  // rows per pass, as registers allow
  T* Kib = kinv + b * nn;
  for (int a = 0; a < n; a += R) {
    const T* Xa[R];
#pragma unroll
    for (int h = 0; h < R; ++h) Xa[h] = XT + min(a + h, n) * ld;  // row n is zero
    T e[R], o[R];
#pragma unroll
    for (int h = 0; h < R; ++h) e[h] = o[h] = T(0);
    for (int k0 = a & ~3; k0 < n; k0 += kChunk) {
      T xv[kChunk];
      load_chunk(Xr + k0, xv);
#pragma unroll
      for (int h = 0; h < R; ++h) {
        T va[kChunk];
        load_chunk(Xa[h] + k0, va);
#pragma unroll
        for (int u = 0; u < kChunk; u += 2) {
          e[h] = fma_t(va[u], xv[u], e[h]);
          o[h] = fma_t(va[u + 1], xv[u + 1], o[h]);
        }
      }
    }
    if (own) {
#pragma unroll
      for (int h = 0; h < R; ++h) {
        if (a + h < n) Kib[(a + h) * n + t] = e[h] + o[h];
      }
    }
  }
}

template <typename T, int TPM>
int launch_tpm(const T* K, const T* r, T* quad, T* logdet, T* alpha, T* kinv,
               int B, int n, int ld, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * (n + 1) + 6) * ld * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvn_qd_kernel<T, TPM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mvn_qd_kernel<T, TPM><<<static_cast<unsigned>(B), TPM, smem, stream>>>(
      K, r, quad, logdet, alpha, kinv, n, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* K, const T* r, T* quad, T* logdet, T* alpha, T* kinv,
           int B, int n, int threads_per_matrix, int ld, void* stream) {
  if (n < 1 || n > kMaxN || B < 0 || n > threads_per_matrix || ld < n + kChunk - 1 ||
      (ld * sizeof(T)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (threads_per_matrix) {
    case 32: return launch_tpm<T, 32>(K, r, quad, logdet, alpha, kinv, B, n, ld, s);
    case 64: return launch_tpm<T, 64>(K, r, quad, logdet, alpha, kinv, B, n, ld, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int bt_mvn_qd_f32(const float* K, const float* r, float* quad,
                             float* logdet, float* alpha, float* kinv, int B,
                             int n, int threads_per_matrix, int ld, void* stream) {
  return launch<float>(K, r, quad, logdet, alpha, kinv, B, n, threads_per_matrix, ld, stream);
}

extern "C" int bt_mvn_qd_f64(const double* K, const double* r, double* quad,
                             double* logdet, double* alpha, double* kinv, int B,
                             int n, int threads_per_matrix, int ld, void* stream) {
  return launch<double>(K, r, quad, logdet, alpha, kinv, B, n, threads_per_matrix, ld, stream);
}
