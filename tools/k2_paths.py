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
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from botorch_tpu_torch.ops import cuda_build  # noqa: E402
from botorch_tpu_torch.ops.kernel_matrix import k2_plan, kernel_matrix_plain  # noqa: E402
from chip_smoke import k2_paths_ms, smi_line  # noqa: E402

SHAPES = ((2, 35, 35, 2), (6, 35, 1, 2), (1, 64, 48, 20), (1, 300, 257, 7),
          (1, 1024, 1024, 8), (1, 4096, 4096, 8),
          # config 5's (TuRBO, d = 20): the SVGP's Kzz, Kzx, Kxx, paths' Kxz
          # and greedy column, the exact GP's paths and train covariance
          (1, 256, 256, 20), (1, 256, 512, 20), (1, 512, 512, 20), (1, 2048, 256, 20),
          (1, 16384, 1, 20), (1, 4096, 2048, 20), (1, 2048, 2048, 20))


def main() -> int:
    cuda_build.build(("kernel_matrix",))
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi_line(), "SMs", num_sms, flush=True)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        for B, n, m, d in SHAPES:
            kw = dict(generator=gen, dtype=torch.float64)
            x = torch.rand(B, n, d, **kw).to(dtype).cuda()
            z = torch.rand(B, m, d, **kw).to(dtype).cuda()
            ls = (0.1 + torch.rand(B, d, **kw)).to(dtype).cuda()
            row = {"B": B, "n": n, "m": m, "d": d, "dtype": str(dtype).split(".")[-1],
                   "picked": k2_plan(B, n, m, d, dtype, num_sms)["path"],
                   **k2_paths_ms(x, z, ls, "rbf", kernel_matrix_plain(x, z, ls, "rbf"))}
            print("K2PATHS", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
