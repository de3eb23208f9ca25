// K2: fused ARD kernel matrix (rbf, matern52, matern32, matern12).
//
// Replaces the Pallas TPU kernel
// `botorch_tpu/ops/pallas_kernels.py::_pallas_kernel_matrix` (body
// `_kernel_body`). For a batch of B problems it computes
//   xs = x / ls, zs = z / ls,
//   d2 = max(|xs|^2 + |zs|^2 - 2 xs zs^T, 0),
//   out = exp(-d2/2)                          (rbf)
//       = (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r) (matern52, r = sqrt(d2))
//       = (1 + sqrt3 r) exp(-sqrt3 r)          (matern32)
//       = exp(-r)                              (matern12)
// with x (B, n, d), z (B, m, d), ls (B, d) and out (B, n, m). Each input may
// be broadcast over the batch with a batch stride of 0 (the BO loop's
// restarts share the train inputs).
//
// What bounds it on an H100: at the BO loop's shapes (n = 35, m <= 35,
// d = 2) it moves ~10 KB and does ~2e4 flops, so it is launch-latency bound;
// at large n*m it is bound by writing the (n, m) output, since the feature
// dimension is small. The design keeps everything but the output out of
// device memory:
//   * one block of 32 x 8 threads per 32 x 32 output tile, each thread
//     holding four outputs of one column in registers;
//   * the scaled x rows and z rows of the tile are staged in shared memory
//     in chunks of 32 features (z padded to 33 words a row, so the threads of
//     a warp read different banks); the sum over d is an FMA loop in the
//     kernel, in the working precision (float32 or float64): no TF32, no
//     library GEMM;
//   * the squared norms ride the same loop, and the epilogue runs in
//     registers; rows and columns past n and m are masked on the store, so
//     no padding is ever written.
// The TPU kernel padded d to 128 lanes and tiled 128 x 128 for the MXU;
// neither is needed here.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kChunk = 32;
constexpr int kRowsPerThread = 4;  // blockDim = (32, kTile / kRowsPerThread)
constexpr int kThreadsY = kTile / kRowsPerThread;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

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

template <typename T, int KIND>
__global__ void __launch_bounds__(kTile * kThreadsY)
kernel_matrix_kernel(const T* __restrict__ x, const T* __restrict__ z,
                     const T* __restrict__ ls, T* __restrict__ out, int n,
                     int m, int d, long long sx, long long sz, long long sl,
                     int tiles_m) {
  __shared__ T xs[kTile][kChunk + 1];
  __shared__ T zs[kTile][kChunk + 1];

  const int b = blockIdx.x / tiles_m;
  const int col0 = (blockIdx.x % tiles_m) * kTile;
  const int row0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const T* xb = x + b * sx;
  const T* zb = z + b * sz;
  const T* lb = ls + b * sl;

  T acc[kRowsPerThread];
  T x2[kRowsPerThread];
  for (int i = 0; i < kRowsPerThread; ++i) {
    acc[i] = T(0);
    x2[i] = T(0);
  }
  T z2 = T(0);

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int t = tid; t < kTile * kChunk; t += kTile * kThreadsY) {
      const int rr = t / kChunk;
      const int kk = t % kChunk;
      const int k = k0 + kk;
      const bool kin = k < d;
      const T l = kin ? lb[k] : T(1);
      const int gr = row0 + rr;
      const int gc = col0 + rr;
      xs[rr][kk] = (kin && gr < n) ? xb[static_cast<size_t>(gr) * d + k] / l : T(0);
      zs[rr][kk] = (kin && gc < m) ? zb[static_cast<size_t>(gc) * d + k] / l : T(0);
    }
    __syncthreads();
    const int kmax = min(kChunk, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const T zv = zs[tx][kk];
      z2 += zv * zv;
      for (int i = 0; i < kRowsPerThread; ++i) {
        const T xv = xs[ty + kThreadsY * i][kk];
        acc[i] += xv * zv;
        x2[i] += xv * xv;
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= m) return;
  T* ob = out + static_cast<size_t>(b) * n * m;
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + kThreadsY * i;
    if (row < n) {
      T d2 = x2[i] + z2 - T(2) * acc[i];
      d2 = d2 > T(0) ? d2 : T(0);
      ob[static_cast<size_t>(row) * m + col] = epilogue<T, KIND>(d2);
    }
  }
}

template <typename T>
int launch(const T* x, const T* z, const T* ls, T* out, int B, int n, int m,
           int d, long long sx, long long sz, long long sl, int kind,
           void* stream) {
  if (B < 0 || n < 0 || m < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || n == 0 || m == 0) return 0;
  const int tiles_m = (m + kTile - 1) / kTile;
  const int tiles_n = (n + kTile - 1) / kTile;
  if (tiles_n > 65535 || static_cast<long long>(tiles_m) * B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tiles_m * B, tiles_n);
  const dim3 block(kTile, kThreadsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: kernel_matrix_kernel<T, 0><<<grid, block, 0, s>>>(x, z, ls, out, n, m, d, sx, sz, sl, tiles_m); break;
    case 1: kernel_matrix_kernel<T, 1><<<grid, block, 0, s>>>(x, z, ls, out, n, m, d, sx, sz, sl, tiles_m); break;
    case 2: kernel_matrix_kernel<T, 2><<<grid, block, 0, s>>>(x, z, ls, out, n, m, d, sx, sz, sl, tiles_m); break;
    case 3: kernel_matrix_kernel<T, 3><<<grid, block, 0, s>>>(x, z, ls, out, n, m, d, sx, sz, sl, tiles_m); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bt_kernel_matrix_f32(const float* x, const float* z,
                                    const float* ls, float* out, int B, int n,
                                    int m, int d, long long sx, long long sz,
                                    long long sl, int kind, void* stream) {
  return launch<float>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, stream);
}

extern "C" int bt_kernel_matrix_f64(const double* x, const double* z,
                                    const double* ls, double* out, int B, int n,
                                    int m, int d, long long sx, long long sz,
                                    long long sl, int kind, void* stream) {
  return launch<double>(x, z, ls, out, B, n, m, d, sx, sz, sl, kind, stream);
}
