// K2: fused ARD kernel matrix (rbf, matern52, matern32, matern12).
//
// Replaces the Pallas TPU kernel
// `botorch_tpu/ops/pallas_kernels.py::_pallas_kernel_matrix` (body
// `_kernel_body`). For a batch of B problems it computes
//   xs = x / ls, zs = z / ls,
//   d2 = |xs - zs|^2 (the TPU kernel: max(|xs|^2 + |zs|^2 - 2 xs zs^T, 0)),
//   out = exp(-d2/2)                          (rbf)
//       = (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r) (matern52, r = sqrt(d2))
//       = (1 + sqrt3 r) exp(-sqrt3 r)          (matern32)
//       = exp(-r)                              (matern12)
// with x (B, n, d), z (B, m, d), ls (B, d) and out (B, n, m). Each input may
// be broadcast over the batch with a batch stride of 0 (the BO loop's
// restarts share the train inputs). Sums run in the working precision
// (float32 or float64): no TF32, no library GEMM. d2 is summed from the
// differences (one subtraction and one FMA per feature), not expanded: the
// expansion cancels |xs|^2 + |zs|^2 down to d2 and keeps a few rounding
// steps of those large terms (|xs|^2 reaches 10^2-10^3 at lengthscales near
// 0.1), while the differences leave a few rounding steps of d2 itself, and
// coincident points give d2 = 0 exactly.
//
// What bounds it on an H100: at the BO loop's shapes it moves a few KB and
// does ~1e4 flops, so it is bound by the launch and by one thread's latency;
// at large n*m it is bound by writing the (n, m) output, since d is small.
// Most launches of the loop are the acquisition's k(X, x) and k(x, x), with
// m = 1 (and n = 35 or 1), so there are two paths, chosen by the wrapper
// (`ops/kernel_matrix.py::k2_plan`):
//   * narrow (n * m <= 4096 per problem): one thread per output, grid
//     (outputs / block, batch). Each thread reads its x row, z row and the
//     lengthscales straight from device memory (L1 serves the shared rows),
//     scales and accumulates them in registers; the feature loop is
//     unrolled for d <= 2, <= 8 and <= 32 and runs in chunks of 32 above.
//     No shared memory, no barrier, and a block is as small as the problem
//     (32 threads for one output);
//   * tiled (larger n * m): a 16*RM x 32 output tile per block of 128
//     threads, RM = 4, 2 or 1 rows a thread, picked so that the grid covers
//     the card's SMs. The tile's scaled x and z rows are staged once per
//     32-feature chunk in shared memory (padded to 33 words a row so the
//     warp's reads hit distinct banks, or broadcast); each thread keeps an
//     RM x 4 micro-tile of sums in registers and stores its 4 columns with
//     16-byte stores when the row length allows.
// Neither path divides by an integer inside a loop; rows and columns past n
// and m are masked on the store, so no padding is ever written. The TPU
// kernel padded d to 128 lanes and tiled 128 x 128 for the MXU; neither is
// needed here.

#include <cuda_runtime.h>

namespace {

constexpr int kNarrowMaxThreads = 128;
constexpr int kChunk = 32;        // features staged per pass (tiled path)
constexpr int kColThreads = 8;    // tiled block: 8 x 16 threads
constexpr int kRowThreads = 16;
constexpr int kColsPerThread = 4;
constexpr int kTileCols = kColThreads * kColsPerThread;  // 32
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int KIND>
__device__ __forceinline__ T epilogue(T d2) {
  if (KIND == 0) return exp_t(T(-0.5) * d2);
  const T r = sqrt_t(d2);
  if (KIND == 1) {
    const T sr = T(2.2360679774997896964) * r;
    return (T(1) + sr + T(5.0 / 3.0) * (r * r)) * exp_t(-sr);
  }
  if (KIND == 2) {
    const T sr = T(1.7320508075688772935) * r;
    return (T(1) + sr) * exp_t(-sr);
  }
  return exp_t(-r);
}

// ------------------------------------------------------------ narrow ---- //
template <typename T, int KIND, int DB>
__global__ void __launch_bounds__(kNarrowMaxThreads)
kernel_matrix_narrow(const T* __restrict__ x, const T* __restrict__ z,
                     const T* __restrict__ ls, T* __restrict__ out, int B,
                     int n, int m, int d, long long sx, long long sz,
                     long long sl) {
  const int nm = n * m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nm) return;
  const int i = idx / m;  // once per thread, outside every loop
  const int j = idx - i * m;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xr = x + b * sx + static_cast<size_t>(i) * d;
    const T* zr = z + b * sz + static_cast<size_t>(j) * d;
    const T* lb = ls + b * sl;
    T d2 = T(0);
    for (int k0 = 0; k0 < d; k0 += DB) {
#pragma unroll
      for (int k = 0; k < DB; ++k) {
        if (k0 + k < d) {
          const T l = lb[k0 + k];
          const T df = xr[k0 + k] / l - zr[k0 + k] / l;
          d2 = fma_t(df, df, d2);
        }
      }
    }
    out[b * nm + idx] = epilogue<T, KIND>(d2);
  }
}

// ------------------------------------------------------------- tiled ---- //
__device__ __forceinline__ void store4(float* p, const float* v, int valid, bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < valid) p[q] = v[q];
  }
}

__device__ __forceinline__ void store4(double* p, const double* v, int valid, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (vec && 2 * h + 1 < valid) {
      reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
    } else {
      if (2 * h < valid) p[2 * h] = v[2 * h];
      if (2 * h + 1 < valid) p[2 * h + 1] = v[2 * h + 1];
    }
  }
}

template <typename T, int KIND, int RM>
__global__ void __launch_bounds__(kColThreads * kRowThreads)
kernel_matrix_tiled(const T* __restrict__ x, const T* __restrict__ z,
                    const T* __restrict__ ls, T* __restrict__ out, int B, int n,
                    int m, int d, long long sx, long long sz, long long sl,
                    int vec) {
  constexpr int TR = kRowThreads * RM;
  __shared__ T xs[TR][kChunk + 1];
  __shared__ T zs[kTileCols][kChunk + 1];
  __shared__ T lsc[kChunk];

  const int tx = threadIdx.x;  // column group: columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.y;  // rows ty, ty + 16, ...
  const int tid = ty * kColThreads + tx;
  const int row0 = blockIdx.y * TR;
  const int col0 = blockIdx.x * kTileCols;
  const size_t nm = static_cast<size_t>(n) * m;

  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    const T* xb = x + b * sx;
    const T* zb = z + b * sz;
    const T* lb = ls + b * sl;
    T acc[RM][kColsPerThread];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) acc[r][q] = T(0);
    }

    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int kc = min(kChunk, d - k0);
      if (tid < kc) lsc[tid] = lb[k0 + tid];
      __syncthreads();
      for (int rr = ty; rr < TR; rr += kRowThreads) {
        const int gr = row0 + rr;
        for (int kk = tx; kk < kChunk; kk += kColThreads) {
          xs[rr][kk] = (gr < n && kk < kc) ? xb[static_cast<size_t>(gr) * d + k0 + kk] / lsc[kk] : T(0);
        }
      }
      for (int cc = ty; cc < kTileCols; cc += kRowThreads) {
        const int gc = col0 + cc;
        for (int kk = tx; kk < kChunk; kk += kColThreads) {
          zs[cc][kk] = (gc < m && kk < kc) ? zb[static_cast<size_t>(gc) * d + k0 + kk] / lsc[kk] : T(0);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        T zv[kColsPerThread];
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q) zv[q] = zs[tx * kColsPerThread + q][kk];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const T xv = xs[ty + kRowThreads * r][kk];
#pragma unroll
          for (int q = 0; q < kColsPerThread; ++q) {
            const T df = xv - zv[q];
            acc[r][q] = fma_t(df, df, acc[r][q]);
          }
        }
      }
      __syncthreads();  // the next chunk (or batch) overwrites the tiles
    }

    const int col = col0 + tx * kColsPerThread;
    T* ob = out + b * nm;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = row0 + ty + kRowThreads * r;
      if (row < n && col < m) {
        T v[kColsPerThread];
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q) v[q] = epilogue<T, KIND>(acc[r][q]);
        store4(ob + static_cast<size_t>(row) * m + col, v, m - col, vec != 0);
      }
    }
  }
}

// ----------------------------------------------------------- launches --- //
template <typename T, int KIND>
void narrow_kind(int bucket, dim3 grid, int threads, cudaStream_t s, const T* x,
                 const T* z, const T* ls, T* out, int B, int n, int m, int d,
                 long long sx, long long sz, long long sl) {
  switch (bucket) {
    case 2: kernel_matrix_narrow<T, KIND, 2><<<grid, threads, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    case 8: kernel_matrix_narrow<T, KIND, 8><<<grid, threads, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    default: kernel_matrix_narrow<T, KIND, 32><<<grid, threads, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl); break;
  }
}

template <typename T>
int launch_narrow(const T* x, const T* z, const T* ls, T* out, int B, int n,
                  int m, int d, long long sx, long long sz, long long sl,
                  int kind, int bucket, int threads, void* stream) {
  if (B < 0 || n < 0 || m < 0 || d < 1 || threads < 32 || threads > kNarrowMaxThreads ||
      (threads & 31) != 0 || (bucket != 2 && bucket != 8 && bucket != 32) ||
      static_cast<long long>(n) * m > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || n == 0 || m == 0) return 0;
  const dim3 grid((n * m + threads - 1) / threads, B < kMaxGridYZ ? B : kMaxGridYZ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: narrow_kind<T, 0>(bucket, grid, threads, s, x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    case 1: narrow_kind<T, 1>(bucket, grid, threads, s, x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    case 2: narrow_kind<T, 2>(bucket, grid, threads, s, x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    case 3: narrow_kind<T, 3>(bucket, grid, threads, s, x, z, ls, out, B, n, m, d, sx, sz, sl); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
void tiled_kind(int rm, int n, cudaStream_t s, const T* x, const T* z,
                const T* ls, T* out, int B, int m, int d, long long sx,
                long long sz, long long sl, int vec) {
  const dim3 block(kColThreads, kRowThreads);
  const unsigned gz = B < kMaxGridYZ ? B : kMaxGridYZ;
  const unsigned gx = (m + kTileCols - 1) / kTileCols;
  const int tr = kRowThreads * rm;
  const dim3 grid(gx, (n + tr - 1) / tr, gz);
  switch (rm) {
    case 1: kernel_matrix_tiled<T, KIND, 1><<<grid, block, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl, vec); break;
    case 2: kernel_matrix_tiled<T, KIND, 2><<<grid, block, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl, vec); break;
    default: kernel_matrix_tiled<T, KIND, 4><<<grid, block, 0, s>>>(x, z, ls, out, B, n, m, d, sx, sz, sl, vec); break;
  }
}

template <typename T>
int launch_tiled(const T* x, const T* z, const T* ls, T* out, int B, int n,
                 int m, int d, long long sx, long long sz, long long sl,
                 int kind, int rows_per_thread, int vec, void* stream) {
  if (B < 0 || n < 0 || m < 0 || d < 1 ||
      (rows_per_thread != 1 && rows_per_thread != 2 && rows_per_thread != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || n == 0 || m == 0) return 0;
  if ((n + kRowThreads * rows_per_thread - 1) / (kRowThreads * rows_per_thread) > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte stores need every row start 16-byte aligned
  if (vec && (m % (16 / static_cast<int>(sizeof(T)))) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: tiled_kind<T, 0>(rows_per_thread, n, s, x, z, ls, out, B, m, d, sx, sz, sl, vec); break;
    case 1: tiled_kind<T, 1>(rows_per_thread, n, s, x, z, ls, out, B, m, d, sx, sz, sl, vec); break;
    case 2: tiled_kind<T, 2>(rows_per_thread, n, s, x, z, ls, out, B, m, d, sx, sz, sl, vec); break;
    case 3: tiled_kind<T, 3>(rows_per_thread, n, s, x, z, ls, out, B, m, d, sx, sz, sl, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bt_kernel_matrix_narrow_f32(const float* x, const float* z, const float* ls,
                                           float* out, int B, int n, int m, int d,
                                           long long sx, long long sz, long long sl,
                                           int kind, int bucket, int threads, void* stream) {
  return launch_narrow<float>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, bucket, threads, stream);
}

extern "C" int bt_kernel_matrix_narrow_f64(const double* x, const double* z, const double* ls,
                                           double* out, int B, int n, int m, int d,
                                           long long sx, long long sz, long long sl,
                                           int kind, int bucket, int threads, void* stream) {
  return launch_narrow<double>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, bucket, threads, stream);
}

extern "C" int bt_kernel_matrix_tiled_f32(const float* x, const float* z, const float* ls,
                                          float* out, int B, int n, int m, int d,
                                          long long sx, long long sz, long long sl,
                                          int kind, int rows_per_thread, int vec, void* stream) {
  return launch_tiled<float>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, rows_per_thread, vec, stream);
}

extern "C" int bt_kernel_matrix_tiled_f64(const double* x, const double* z, const double* ls,
                                          double* out, int B, int n, int m, int d,
                                          long long sx, long long sz, long long sl,
                                          int kind, int rows_per_thread, int vec, void* stream) {
  return launch_tiled<double>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, rows_per_thread, vec, stream);
}
