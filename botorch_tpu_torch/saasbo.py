r"""SAASBO closed loop (counterpart of `botorch_tpu/saasbo.py`): config 3 of
`BASELINE.json`.

Every iteration refits the SAAS model by NUTS (`fit_saas_gp`, chains
batched) on the padded history and maximizes an ensemble-reduced analytic
acquisition over the unit cube. The history lives in buffers of capacity
`n_init + iterations` with a validity mask, so the NUTS potential
launches K1 and K2 at one shape for the whole loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from botorch_tpu_torch.acquisition.analytic import make_acqf
from botorch_tpu_torch.models.fully_bayesian import (
    fit_saas_gp,
    load_saas_samples,
    median_lengthscales,
)
from botorch_tpu_torch.models.gp import make_gp
from botorch_tpu_torch.optim.optimize import optimize_acqf
from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
from botorch_tpu_torch.settings import make_generator, resolve_device, resolve_dtype

Tensor = torch.Tensor


class SaasboResult(NamedTuple):
    X: Tensor  # (n, d)
    Y: Tensor  # (n,)
    best_curve: Tensor  # (iterations,)
    median_lengthscales: Tensor  # (iterations, d)


def saasbo_step(
    X: Tensor,
    Y: Tensor,
    n: int,
    generator: torch.Generator,
    seed: int = 0,
    num_warmup: int = 256,
    num_samples: int = 128,
    thinning: int = 8,
    num_chains: int = 8,
    max_depth: int = 6,
    acqf_name: str = "LogEI",
    num_restarts: int = 4,
    raw_samples: int = 64,
    acq_maxiter: int = 50,
    z_samples: Optional[Tensor] = None,
    initial_conditions: Optional[Tensor] = None,
):
    """One SAASBO iteration on padded buffers `X (capacity, d)`, `Y
    (capacity,)` whose first `n` rows are valid: NUTS fit, acquisition, its
    maximization. `z_samples (S, k)` replaces the NUTS fit with these
    draws, and `initial_conditions (r, 1, d)` the acquisition's
    initial-condition selection. Returns `(candidate (1, d), value, model,
    NUTS stats)`."""
    device = X.device
    capacity, d = X.shape
    mask = torch.arange(capacity, device=device) < n
    if z_samples is None:
        model, stats = fit_saas_gp(
            X, Y, generator, num_warmup=num_warmup, num_samples=num_samples,
            thinning=thinning, num_chains=num_chains, max_depth=max_depth, mask=mask,
            dtype=X.dtype, device=device,
        )
    else:
        base = make_gp(X, Y, kernel="matern52", use_outputscale=True, mask=mask,
                       dtype=X.dtype, device=device)
        model, stats = load_saas_samples(z_samples, base), {}
    best_f = torch.max(torch.where(mask, Y, -torch.inf))
    acqf = make_acqf(acqf_name, model, best_f=best_f)
    unit_bounds = torch.stack([torch.zeros(d, dtype=X.dtype, device=device),
                               torch.ones(d, dtype=X.dtype, device=device)])
    cand, val = optimize_acqf(
        acqf, unit_bounds, q=1, num_restarts=num_restarts, raw_samples=raw_samples,
        generator=generator, maxiter=acq_maxiter, seed=seed * 997,
        initial_conditions=initial_conditions, device=device,
    )
    return cand, val, model, stats


def run_saasbo(
    objective: Callable[[Tensor], Tensor],
    d: int,
    n_init: int,
    iterations: int,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **step_kwargs,
) -> SaasboResult:
    """SAASBO for `objective: (q, d) -> (q,)`, MAXIMIZED on the unit cube,
    on `device` (CUDA unless given).

    `seed` sets the scrambled-Sobol initial design and the acquisition's
    raw-sample seed (`seed * 997`, every iteration); `generator` (seeded
    with `seed` if None) draws the NUTS chains and the initial-condition
    selection. The buffers hold `n_init + iterations` rows. `step_kwargs`
    are `saasbo_step`'s budgets (defaults: 256 warmup draws, 128 samples,
    thinning 8, 8 chains, depth 6, LogEI with 4 restarts, 64 raw samples
    and 50 iterations)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if generator is None:
        generator = make_generator(seed, device)
    sv, shift = sobol_table(d, scramble=True, seed=seed, device=device)
    X0 = draw_sobol(sv, shift, n_init, dtype=dtype)
    capacity = n_init + iterations
    X = torch.zeros((capacity, d), dtype=dtype, device=device)
    Y = torch.zeros((capacity,), dtype=dtype, device=device)
    X[:n_init] = X0
    Y[:n_init] = objective(X0).to(dtype)
    n = n_init
    best_curve, ml_hist = [], []
    for _ in range(iterations):
        cand, _, model, _ = saasbo_step(X, Y, n, generator, seed=seed, **step_kwargs)
        ml_hist.append(median_lengthscales(model))
        X, Y = X.clone(), Y.clone()  # the model holds the buffers it was fit on
        X[n] = cand[0]
        Y[n] = objective(cand)[0].to(dtype)
        n += 1
        best_curve.append(torch.max(Y[:n]))
    return SaasboResult(
        X=X[:n], Y=Y[:n], best_curve=torch.stack(best_curve),
        median_lengthscales=torch.stack(ml_hist),
    )
