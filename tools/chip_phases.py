"""Chosen phases of `chip_smoke.py` alone, on one card, for a short run that
checks a new path before the whole script:

    python3 tools/chip_phases.py build k2_config5 turbo_step turbo_exact turbo_svgp

Each name is a phase of `chip_smoke.py` (`build`, `k1`, `k2`, `bo_step`,
`bo_loop`, `mc_step`, `qnei_loop`, `nuts_step`, `nuts`, `saasbo_loop`,
`mo_step`, `mo_loop`, `turbo_step`, `turbo_exact`, `turbo_svgp`,
`constrained_step`, `constrained_loop`),
`k2_config4`: the k2 phase's cases at config 4's shapes alone (rbf,
float32 and float64, both paths timed), `k2_config5`: its cases at
config 5's loops' shapes (float32, both paths timed), `k2_constrained`:
its cases at the constrained loops' shapes (rbf, float32 and float64), or
`saasbo_loop_profiled`: the saasbo_loop phase with its profiled step,
which `chip_smoke.py` leaves out for time. Build the
kernels first (`build`) unless an earlier call in the same process did.
Prints one JSON line per phase, as `chip_smoke.py` does, with the phase's
wall seconds (`phase_s`), then the card's name and power limit; exits
non-zero if a phase failed.
"""

import inspect
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


# the k2 phase's cases at one config's shapes alone, both paths timed
K2_CONFIGS = {
    "k2_config4": ([(shape, "rbf") for shape in cs.CONFIG4_K2], (torch.float32, torch.float64)),
    "k2_config5": (cs.CONFIG5_K2, (torch.float32,)),
    "k2_constrained": (cs.CONSTRAINED_K2, (torch.float32, torch.float64)),
}


def k2_config(name, gen) -> dict:
    table, dtypes = K2_CONFIGS[name]
    floor = cs.floor_ms()
    cases = cs.k2_config_cases(table, dtypes, gen, floor)
    return {"phase": name, "ok": all(c["ok"] for c in cases), "floor_ms": floor,
            "cases": cases}


def phase(name):
    """`chip_smoke.phase_<name>`, this script's `k2_config4`, `k2_config5`
    or `k2_constrained`, or `saasbo_loop_profiled`; None if none exists."""
    if name in K2_CONFIGS:
        return lambda gen: k2_config(name, gen)
    if name == "saasbo_loop_profiled":
        return lambda: cs.phase_saasbo_loop(profile=True)
    return getattr(cs, f"phase_{name}", None)


def main(names) -> int:
    gen = torch.Generator().manual_seed(0)
    unknown = [n for n in names if phase(n) is None]
    if unknown or not names:
        print(f"chip_phases: unknown phases {unknown}", file=sys.stderr)
        return 2
    failed = []
    for name in names:
        fn = phase(name)
        t0 = time.perf_counter()
        try:
            # the kernel phases draw their inputs from one shared generator
            res = fn(gen) if "gen" in inspect.signature(fn).parameters else fn()
        except Exception:  # a phase that raises is a failed phase
            traceback.print_exc()
            res = {"phase": name, "ok": False, "error": traceback.format_exc(limit=5)}
        res.setdefault("ok", True)
        res["phase_s"] = time.perf_counter() - t0
        cs.emit(res)
        if not res["ok"]:
            failed.append(name)
    print(cs.smi_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
