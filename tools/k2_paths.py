"""K2's two paths timed against each other at the same shapes on one card.

    python3 tools/k2_paths.py

builds `csrc/kernel_matrix.cu`, launches its narrow kernel (one thread per
output) and its tiled kernel (register micro-tiles) through their C entry
points at each shape below, rbf, in float32 and float64, checks both
against the plain version, and prints one line per shape and dtype with
the device milliseconds of each path (`torch.profiler`, as `chip_smoke.py`
times its cases; `*_timing` is "events" where the profiler saw no device
time and CUDA events timed the host-inclusive call instead) and the path
`k2_plan` picks there. The first shapes are
the config-1 loop's; the larger ones are the covariances of MC
acquisition over a few hundred to a few thousand points.
"""

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from botorch_tpu_torch.ops import cuda_build  # noqa: E402
from botorch_tpu_torch.ops.kernel_matrix import (  # noqa: E402
    TILE_COLS, TILE_ROWS_PER_THREAD, _KIND, _functions, k2_plan, kernel_matrix_plain,
)
from chip_smoke import device_ms, max_err, smi_line  # noqa: E402

SHAPES = ((2, 35, 35, 2), (6, 35, 1, 2), (1, 64, 48, 20), (1, 300, 257, 7),
          (1, 1024, 1024, 8), (1, 4096, 4096, 8))


def params(path: str, B: int, n: int, m: int, d: int, dtype, num_sms: int) -> tuple:
    """The two path parameters of the C entry point, as `k2_plan` would set
    them had it picked `path`."""
    if path == "narrow":
        return (2 if d <= 2 else 8 if d <= 8 else 32, 128)
    for rm in TILE_ROWS_PER_THREAD:
        if math.ceil(m / TILE_COLS) * math.ceil(n / (16 * rm)) * B >= num_sms:
            break
    return (rm, int(m % (16 // dtype.itemsize) == 0))


def main() -> int:
    cuda_build.build(("kernel_matrix",))
    fns = _functions()
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi_line(), "SMs", num_sms, flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.float64):
        for B, n, m, d in SHAPES:
            kw = dict(generator=gen, dtype=torch.float64)
            x = torch.rand(B, n, d, **kw).to(dtype).cuda()
            z = torch.rand(B, m, d, **kw).to(dtype).cuda()
            ls = (0.1 + torch.rand(B, d, **kw)).to(dtype).cuda()
            ref = kernel_matrix_plain(x, z, ls, "rbf")
            row = {"B": B, "n": n, "m": m, "d": d, "dtype": str(dtype).split(".")[-1],
                   "picked": k2_plan(B, n, m, d, dtype, num_sms)["path"]}
            for path in ("narrow", "tiled"):
                out = torch.empty_like(ref)
                args = (x.data_ptr(), z.data_ptr(), ls.data_ptr(), out.data_ptr(), B, n, m, d,
                        n * d, m * d, d, _KIND["rbf"], *params(path, B, n, m, d, dtype, num_sms),
                        stream)

                def launch(fn=fns[path, dtype], args=args):
                    cuda_build.check(fn(*args), f"kernel_matrix {path}")

                launch()
                row[f"{path}_err"] = max_err(out, ref)
                row[f"{path}_ms"], row[f"{path}_timing"] = device_ms(launch)
            print("K2PATHS", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
