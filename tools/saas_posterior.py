"""The SAAS posterior that `fit_saas_gp` samples at one fixed history,
over generator seeds, on each device given: config 3's fit (8 chains,
256 warmup draws, 128 samples, thinning 8, depth 6) on the first 20
scrambled-Sobol points (seed 0) of Branin embedded in d = 8 (dims 0 and 1
active), padded to config 3's 26 rows.

A loop's final regret mixes every iteration's sampling noise with the
acquisition's choices, and a float32 NUTS run parts from any other
run of different rounding within one fit; the posterior at fixed data
is what two devices must agree on. Per seed it records the ensemble's
median lengthscales, the ensemble mean at 32 fixed test points, the
accept probability, the divergence rate and the step size; per device the means over seeds
with their standard errors; and for two devices the difference of the
per-dimension mean log median lengthscale in units of its standard
error (`z_log_ls`), of its mean over the six distractor dimensions
(`z_distractors`: they share the global shrinkage, so their per-dimension
z move together), and of the test-point means (`z_mean`).

    python3 tools/saas_posterior.py [num_seeds] [devices] [first_seed]  # e.g. 16 cuda,cpu 1
    python3 tools/saas_posterior.py compare runs.jsonl ...  # the same lines from saved output
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from botorch_tpu_torch.models.fully_bayesian import fit_saas_gp, median_lengthscales  # noqa: E402
from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table  # noqa: E402
from botorch_tpu_torch.settings import make_generator  # noqa: E402
from botorch_tpu_torch.test_functions.synthetic import Branin  # noqa: E402
from botorch_tpu_torch.utils.transforms import unnormalize  # noqa: E402

D, CAPACITY, N_VALID = 8, 26, 20
FIT = dict(num_warmup=256, num_samples=128, thinning=8, num_chains=8, max_depth=6)


def history():
    """The padded history `(X (26, 8), Y (26,), mask)` and 32 test points,
    as float32 numpy arrays."""
    sv, shift = sobol_table(D, scramble=True, seed=0, device="cpu")
    X = np.zeros((CAPACITY, D), np.float32)
    X[:N_VALID] = draw_sobol(sv, shift, N_VALID).numpy()
    prob = Branin(negate=True)
    Y = np.zeros(CAPACITY, np.float32)
    Y[:N_VALID] = prob(unnormalize(torch.tensor(X[:N_VALID, :2]), prob.bounds)).numpy()
    X_test = np.random.default_rng(0).uniform(size=(32, D)).astype(np.float32)
    return X, Y, np.arange(CAPACITY) < N_VALID, X_test


def fit_stats(seed: int, device: str) -> dict:
    X, Y, mask, X_test = history()
    t0 = time.perf_counter()
    model, stats = fit_saas_gp(torch.tensor(X, device=device), torch.tensor(Y, device=device),
                               make_generator(seed, device), mask=torch.tensor(mask, device=device),
                               device=device, **FIT)
    mean = model.posterior(torch.tensor(X_test, device=device)).mean.reshape(-1, len(X_test))
    return {"seed": seed, "log_median_ls": torch.log(median_lengthscales(model)).tolist(),
            "test_mean": mean.mean(0).tolist(), "accept": float(stats["accept_prob"]),
            "divergence_rate": float(stats["divergence_rate"]),
            "step_size": float(stats["step_size"]), "wall_s": time.perf_counter() - t0}


def summary(records: list) -> dict:
    L = np.array([r["log_median_ls"] for r in records])
    return {"log_median_ls_mean": L.mean(0).tolist(),
            "log_median_ls_se": (L.std(0, ddof=1) / np.sqrt(len(L))).tolist(),
            "accept_mean": float(np.mean([r["accept"] for r in records])),
            "divergence_rate_mean": float(np.mean([r.get("divergence_rate", np.nan) for r in records])),
            "step_size_mean": float(np.mean([r["step_size"] for r in records]))}


def z_scores(a: list, b: list, key: str) -> list:
    A, B = np.array([r[key] for r in a]), np.array([r[key] for r in b])
    se = np.sqrt(A.var(0, ddof=1) / len(A) + B.var(0, ddof=1) / len(B))
    return ((A.mean(0) - B.mean(0)) / np.maximum(se, 1e-12)).tolist()


def compare(runs: dict) -> dict:
    devices = list(runs)
    a, b = runs[devices[0]], runs[devices[1]]
    for r in a + b:
        r["log_median_ls_distractors"] = float(np.mean(r["log_median_ls"][2:]))
    return {"compare": devices, "seeds": [len(a), len(b)],
            "z_log_ls": z_scores(a, b, "log_median_ls"),
            "z_distractors": z_scores(a, b, "log_median_ls_distractors"),
            "z_mean_max_abs": float(np.max(np.abs(z_scores(a, b, "test_mean"))))}


def main():
    runs = {}
    if len(sys.argv) > 1 and sys.argv[1] == "compare":
        for path in sys.argv[2:]:
            for line in Path(path).read_text().splitlines():
                r = json.loads(line) if line.startswith("{") else {}
                if "seed" in r:
                    runs.setdefault(r["device"], {})[r["seed"]] = r
        runs = {dev: [by_seed[s] for s in sorted(by_seed)] for dev, by_seed in runs.items()}
    else:
        num_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 16
        devices = sys.argv[2].split(",") if len(sys.argv) > 2 else ["cuda", "cpu"]
        first = int(sys.argv[3]) if len(sys.argv) > 3 else 1
        if "cuda" in devices and not torch.cuda.is_available():
            sys.exit("tools/saas_posterior.py: no CUDA device")
        for device in devices:
            runs[device] = []
            for seed in range(first, first + num_seeds):
                runs[device].append(fit_stats(seed, device))
                print(json.dumps(dict(runs[device][-1], device=device)), flush=True)
    for device, records in runs.items():
        print(json.dumps({"device": device, "seeds": len(records), **summary(records)}), flush=True)
    if len(runs) == 2:
        print(json.dumps(compare(runs)), flush=True)


if __name__ == "__main__":
    main()
