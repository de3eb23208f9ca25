"""Config 3 (SAASBO, `bench.py:127-172`) over seeds on the card, as
`bench.py` runs it: the initial design and the acquisition's raw-sample
seed from `seed=0`, the NUTS and initial-condition draws from a generator
seeded 1..N; bench budgets (256/128/8, 8 chains, depth 6, 32 restarts,
512 raw samples, 50 ascent iterations). Prints one JSON line per seed and
one with the mean final regret, beside the reference's 0.613 and the
replica bar 0.919 (`bench.py`).

    python3 tools/saasbo_seeds.py [num_seeds]
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from botorch_tpu_torch.saasbo import run_saasbo  # noqa: E402
from botorch_tpu_torch.settings import make_generator  # noqa: E402
from chip_smoke import CONFIG3, SAASBO_CFG, _branin_embedded, smi_line  # noqa: E402

BRANIN_OPT = 0.397887


def main():
    if not torch.cuda.is_available():
        sys.exit("tools/saasbo_seeds.py runs on a CUDA card")
    num_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    print(smi_line(), flush=True)
    objective = _branin_embedded()
    regrets = []
    for rep in range(num_seeds):
        t0 = time.perf_counter()
        res = run_saasbo(objective, d=CONFIG3["d"], n_init=CONFIG3["n_init"],
                         iterations=CONFIG3["iterations"], seed=0,
                         generator=make_generator(rep + 1, "cuda"), **SAASBO_CFG)
        torch.cuda.synchronize()
        regrets.append(-float(res.best_curve[-1]) - BRANIN_OPT)
        print(json.dumps({"generator_seed": rep + 1, "regret": regrets[-1],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"seeds": num_seeds, "mean_regret": sum(regrets) / len(regrets),
                      "reference_mean": 0.613, "replica_bar": 0.919}), flush=True)


if __name__ == "__main__":
    main()
