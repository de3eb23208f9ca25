"""What one warp pays per element for the inner-loop patterns of K1.

    python3 tools/warp_costs.py

builds a one-warp microbenchmark into `build/tools/` and prints SM cycles
per element (512 elements each) of: a row update from a shuffled column,
the same update reading the column from shared memory, a dot product from
shared memory, shuffles alone, and the dot product with 16-byte loads.
These are the latencies a lone warp exposes when no other warp hides them.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from botorch_tpu_torch.ops import cuda_build  # noqa: E402

SOURCE = r"""
extern "C" __global__ void warp_costs(float* out, long long* clk) {
  __shared__ float A[64 * 72];
  __shared__ float col[80];
  const int lane = threadIdx.x;
  float* row = A + lane * 73 % (64 * 72 - 80);
  for (int t = lane; t < 64 * 72; t += 32) A[t] = 1.0f + t * 1e-6f;
  if (lane < 80) col[lane] = 0.5f;
  __syncwarp();
  const float l0 = 0.25f + lane;
  float acc = 0.f;
  long long t0 = clock64();
  for (int rep = 0; rep < 8; ++rep)
    for (int k0 = 0; k0 < 64; k0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = row[k0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) row[k0 + u] = fmaf(-l0, __shfl_sync(0xffffffffu, l0, (k0 + u) & 31), v[u]);
    }
  __syncwarp();
  long long t1 = clock64();
  for (int rep = 0; rep < 8; ++rep)
    for (int k0 = 0; k0 < 64; k0 += 8) {
      float v[8], c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) { v[u] = row[k0 + u]; c[u] = col[k0 + u]; }
#pragma unroll
      for (int u = 0; u < 8; ++u) row[k0 + u] = fmaf(-l0, c[u], v[u]);
    }
  __syncwarp();
  long long t2 = clock64();
  for (int rep = 0; rep < 8; ++rep)
    for (int k0 = 0; k0 < 64; k0 += 8) {
      float v[8], c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) { v[u] = row[k0 + u]; c[u] = col[k0 + u]; }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = fmaf(c[u], v[u], acc);
    }
  long long t3 = clock64();
  for (int rep = 0; rep < 8; ++rep)
    for (int k = 0; k < 64; ++k) acc += __shfl_sync(0xffffffffu, l0, k & 31);
  long long t4 = clock64();
  for (int rep = 0; rep < 8; ++rep)
    for (int k0 = 0; k0 < 64; k0 += 8) {
      const float4* r4 = reinterpret_cast<const float4*>(A + (lane * 76) % (64 * 72 - 80) / 4 * 4 + k0);
      const float4* c4 = reinterpret_cast<const float4*>(col + k0);
      const float4 a = r4[0], b = r4[1], c = c4[0], d = c4[1];
      acc = fmaf(a.x, c.x, acc); acc = fmaf(a.y, c.y, acc); acc = fmaf(a.z, c.z, acc); acc = fmaf(a.w, c.w, acc);
      acc = fmaf(b.x, d.x, acc); acc = fmaf(b.y, d.y, acc); acc = fmaf(b.z, d.z, acc); acc = fmaf(b.w, d.w, acc);
    }
  long long t5 = clock64();
  out[lane] = acc + row[lane];
  if (lane == 0) { clk[0] = t1 - t0; clk[1] = t2 - t1; clk[2] = t3 - t2; clk[3] = t4 - t3; clk[4] = t5 - t4; }
}
"""
NAMES = ("update_shuffled_column", "update_shared_column", "dot_shared", "shuffle_only", "dot_16_byte_loads")


def main() -> int:
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "warp_costs.cu").write_text(SOURCE)
    cubin = out_dir / "warp_costs.cubin"
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
                    "-o", str(cubin), str(out_dir / "warp_costs.cu")], check=True)
    torch.zeros(1, device="cuda")  # a context for the driver API
    cuda = ctypes.CDLL("libcuda.so.1")
    mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
    if cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()) or cuda.cuModuleGetFunction(
            ctypes.byref(fn), mod, b"warp_costs"):
        raise RuntimeError("could not load the microbenchmark")
    out = torch.zeros(32, device="cuda")
    clk = torch.zeros(8, dtype=torch.int64, device="cuda")
    args = [ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(clk.data_ptr())]
    ptrs = (ctypes.c_void_p * 2)(*[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p) for a in args])
    for _ in range(3):  # the last of three runs, warm
        if cuda.cuLaunchKernel(fn, 1, 1, 1, 32, 1, 1, 0, None, ptrs, None):
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
    print({name: c / 512 for name, c in zip(NAMES, clk.tolist())}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
