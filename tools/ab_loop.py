"""The config-1 loop of one checkout, for comparing two commits on one card.

    python3 tools/ab_loop.py ROOT

imports `chip_smoke.py` from the checkout at ROOT (the repository root, or
an unpacked older commit, e.g. `git archive <commit> | tar -x -C build/parent`),
builds its kernels and runs its `bo_loop` phase, then prints one line
`AB {...}` with the loop's wall time, iterations/s, regret, launch counts
and the profiled step. Run the two checkouts in turns in one call
(parent, change, change, parent): the loop is host-bound and its wall time
moves with the machine.
"""

import json
import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not the checkout at {root}")
    chip_smoke.phase_build()
    res = chip_smoke.phase_bo_loop()
    step = res["last_step"]
    print("AB", json.dumps({
        "root": sys.argv[1], "wall_s": res["wall_s"], "iters_per_s": res["iters_per_s"],
        "regret": res["regret"], "launches": res["launches"],
        "step_wall_ms": step["wall_ms"], "step_busy_ms": step["device_busy_ms"],
        "idle_share": step["idle_share"], "step_launches": step["device_launches"],
        "k1": step["mvn_quad_logdet"], "k2": step["kernel_matrix"],
    }), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
