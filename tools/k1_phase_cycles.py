"""Where K1's time goes: SM cycles per phase of `csrc/mvn_quad_logdet.cu`.

    python3 tools/k1_phase_cycles.py

builds a copy of the kernel source with `clock64()` stamps at its phase
comments (load, Cholesky with the rows of X, w and alpha, Kinv) into
`build/tools/`, runs it once per shape on the card and prints the cycles
of each phase as thread 0 of block 0 sees them. The copy is made by text
replacement at those comments, so the script fails if they are renamed.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from botorch_tpu_torch.ops import cuda_build  # noqa: E402
from botorch_tpu_torch.ops.mvn_linalg import k1_launch  # noqa: E402

MARKS = ("  // ---- Cholesky, right-looking, and X", "  const T logs = own ?",
         "  // ---- w = X r, quad and logdet ----", "  // ---- Kinv = X^T X, R rows")
END = "        if (a + h < n) Kib[(a + h) * n + t] = e[h] + o[h];\n      }\n    }\n  }\n}\n"
STAMP = "  if (threadIdx.x == 0 && blockIdx.x == 0) g_clk[{}] = clock64() - c0;\n"


def instrumented_source() -> str:
    src = cuda_build.source_path("mvn_quad_logdet").read_text()
    src = src.replace("namespace {\n", "__device__ long long g_clk[8];\nnamespace {\n", 1)
    start = "  const long long b = blockIdx.x;  // its matrix\n"
    if start not in src:
        raise RuntimeError("start of the kernel not found")
    src = src.replace(start, start + "  const long long c0 = clock64();\n")
    for i, mark in enumerate(MARKS):
        if mark not in src:
            raise RuntimeError(f"phase comment not found: {mark!r}")
        src = src.replace(mark, STAMP.format(i) + mark)
    if END not in src:
        raise RuntimeError("end of the kernel not found")
    src = src.replace(END, END[:-2] + STAMP.format(len(MARKS)) + "}\n")
    return src + ('\nextern "C" int bt_read_clk(long long* h) {\n'
                  "  return (int)cudaMemcpyFromSymbol(h, g_clk, sizeof(long long) * 8);\n}\n")


def main() -> int:
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k1_clock.cu").write_text(instrumented_source())
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / "libk1clock.so"),
                    str(out / "k1_clock.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libk1clock.so"))
    lib.bt_read_clk.argtypes = [ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    for dtype, fn in ((torch.float32, lib.bt_mvn_qd_f32), (torch.float64, lib.bt_mvn_qd_f64)):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for B, n in ((2, 35), (1, 13), (1, 31), (8, 64)):
            A = torch.randn(B, n, n, generator=gen, dtype=torch.float64)
            K = (A @ A.mT + n * torch.eye(n, dtype=torch.float64)).to(dtype).cuda()
            r = torch.randn(B, n, generator=gen, dtype=torch.float64).to(dtype).cuda()
            outs = [torch.empty(B, dtype=dtype, device="cuda"), torch.empty(B, dtype=dtype, device="cuda"),
                    torch.empty(B, n, dtype=dtype, device="cuda"), torch.empty(B, n, n, dtype=dtype, device="cuda")]
            shape = k1_launch(B, n, dtype)
            for _ in range(5):  # the last of five runs, warm
                status = fn(K.data_ptr(), r.data_ptr(), *[o.data_ptr() for o in outs], B, n,
                            shape["threads_per_matrix"], shape["ld"],
                            torch.cuda.current_stream().cuda_stream)
                cuda_build.check(status, "instrumented mvn_quad_logdet")
                torch.cuda.synchronize()
            clk = (ctypes.c_longlong * 8)()
            lib.bt_read_clk(clk)
            c = list(clk)[:5]
            phases = dict(zip(("load", "cholesky_and_X", "logdet", "w_alpha", "kinv"),
                              [c[0]] + [c[i] - c[i - 1] for i in range(1, 5)]))
            print(str(dtype).split(".")[-1], (B, n), "cycles", phases, "total", c[4], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
