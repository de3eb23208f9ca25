r"""Closed-loop Bayesian optimization (counterpart of `botorch_tpu/loop.py`).

The history lives in fixed-size padded buffers with a validity mask, as
in the reference, so every iteration works on the same shapes. Each
iteration fits the GP (warm-started from the previous iteration's MAP
estimate), builds the acquisition (an analytic one, or qLogNEI over the
padded history with fresh qMC base samples), maximizes it, and appends the
evaluated candidates. PyTorch runs eagerly: the loop is a Python loop, and
all tensors stay on the chosen device (CUDA unless given).

Entry points:
  * `bo_step`: one fit + acquire + optimize step for an external objective;
    the caller evaluates the candidate and calls `append_observations`.
  * `run_bo_loop`: the whole loop for an objective on tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from botorch_tpu_torch.acquisition.analytic import ANALYTIC
from botorch_tpu_torch.acquisition.monte_carlo import (
    draw_fresh_base_samples,
    qLogNoisyExpectedImprovement,
)
from botorch_tpu_torch.fit import fit_gp
from botorch_tpu_torch.models.gp import GPParams, make_gp
from botorch_tpu_torch.optim.optimize import optimize_acqf
from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table
from botorch_tpu_torch.settings import make_generator, resolve_device, resolve_dtype

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
# Sobol seed of the qLogNEI base samples (each step XORs a fresh shift in)
_BASE_SAMPLES_SEED = 17


@dataclass(frozen=True)
class BOState:
    """Padded BO history in the unit cube; `n` is the number of valid rows."""

    X: Tensor  # (N_max, d) candidates in [0, 1]^d
    Y: Tensor  # (N_max,) observations (original units)
    n: int


def init_state(
    n_init: int, d: int, capacity: int, seed: int = 0, device=None, dtype=None
) -> tuple[BOState, Tensor]:
    """Scrambled-Sobol initial design. Returns the state (Y zeros: fill it
    with `append_observations` after evaluating) and the initial X block."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    sv, shift = sobol_table(d, scramble=True, seed=seed, device=device)
    X0 = draw_sobol(sv, shift, n_init, dtype=dtype)
    X = torch.zeros((capacity, d), dtype=dtype, device=device)
    X[:n_init] = X0
    state = BOState(X=X, Y=torch.zeros((capacity,), dtype=dtype, device=device), n=0)
    return state, X0


def append_observations(state: BOState, X_new: Tensor, Y_new: Tensor) -> BOState:
    """Write a `(q, d)` block and `(q,)` observations at the fill point."""
    q = X_new.shape[0]
    if state.n + q > state.X.shape[0]:
        raise ValueError(f"state is full: capacity {state.X.shape[0]}")
    X = state.X.clone()
    Y = state.Y.clone()
    X[state.n:state.n + q] = X_new.to(X.dtype)
    Y[state.n:state.n + q] = Y_new.to(Y.dtype)
    return BOState(X=X, Y=Y, n=state.n + q)


def _bo_step(
    state: BOState,
    sobol: tuple[Tensor, Tensor],
    generator: torch.Generator,
    acqf_name: str = "LogEI",
    q: int = 1,
    num_restarts: int = 8,
    raw_samples: int = 64,
    fit_restarts: int = 4,
    fit_maxiter: int = 60,
    acq_maxiter: int = 60,
    kernel: str = "rbf",
    mc_samples: int = 128,
    params0: Optional[GPParams] = None,
    fit_x0: Optional[Tensor] = None,
    initial_conditions: Optional[Tensor] = None,
    base_samples: Optional[Tensor] = None,
):
    """One BO iteration on the padded state: MAP-fit the GP on the masked
    history, build the acquisition, maximize it in the unit cube.

    Returns `(candidates (q, d), acq_value, fitted GPParams)`. `params0`
    warm-starts restart 0 of the fit; `fit_x0`, `initial_conditions` and
    `base_samples` (qLogNEI's `(mc_samples, capacity + q, 1)`) replace the
    fit's restart starts, the acquisition's initial conditions and its
    base samples (drawn from `generator` otherwise)."""
    if acqf_name not in ANALYTIC and acqf_name != "qLogNEI":
        raise NotImplementedError(
            f"acquisition {acqf_name!r} is not ported yet; have "
            f"{sorted(ANALYTIC) + ['qLogNEI']}"
        )
    device = state.X.device
    capacity, d = state.X.shape
    mask = torch.arange(capacity, device=device) < state.n
    model = make_gp(
        state.X, state.Y[:, None], mask=mask, kernel=kernel,
        dtype=state.X.dtype, device=device,
    )
    if params0 is not None:
        model = model.replace(params=params0)
    model = fit_gp(
        model, generator, num_restarts=fit_restarts, maxiter=fit_maxiter,
        x0=fit_x0, device=device,
    )
    if acqf_name == "qLogNEI":
        if base_samples is None:
            base_samples = draw_fresh_base_samples(
                capacity + q, 1, mc_samples, generator, seed=_BASE_SAMPLES_SEED
            )
        acqf = qLogNoisyExpectedImprovement(
            model=model, cache=model.train_chol(),
            base_samples=torch.as_tensor(base_samples, device=device),
            X_baseline=state.X, baseline_mask=mask,
        )
    else:
        acqf_cls = ANALYTIC[acqf_name]
        kwargs = {}
        if "best_f" in acqf_cls.__dataclass_fields__:
            kwargs["best_f"] = torch.max(torch.where(mask, state.Y, -torch.inf))
        acqf = acqf_cls(model=model, cache=model.train_chol(), **kwargs)

    unit_bounds = torch.stack(
        [torch.zeros(d, dtype=state.X.dtype, device=device),
         torch.ones(d, dtype=state.X.dtype, device=device)]
    )
    # Continue the shared Sobol stream: each step draws `raw_samples`
    # points from an offset set by the fill level (uint32 arithmetic).
    skip = ((state.n + 1) * raw_samples) & _MASK32
    cand, val = optimize_acqf(
        acqf, unit_bounds, q=q, num_restarts=num_restarts,
        raw_samples=raw_samples, generator=generator, maxiter=acq_maxiter,
        initial_conditions=initial_conditions, sobol=sobol, sobol_skip=skip,
        device=device,
    )
    return cand, val, model.params


def bo_step(
    state: BOState,
    sobol: tuple[Tensor, Tensor],
    generator: Optional[torch.Generator] = None,
    acqf_name: str = "LogEI",
    q: int = 1,
    num_restarts: int = 8,
    raw_samples: int = 64,
    fit_restarts: int = 4,
    fit_maxiter: int = 60,
    acq_maxiter: int = 60,
    kernel: str = "rbf",
    mc_samples: int = 128,
    device=None,
) -> tuple[Tensor, Tensor]:
    """Public single step (see `_bo_step`) on `device` (CUDA unless given);
    returns `(candidates (q, d), acq_value)`."""
    device = resolve_device(device)
    state = BOState(X=state.X.to(device), Y=state.Y.to(device), n=state.n)
    sobol = (sobol[0].to(device), sobol[1].to(device))
    if generator is None:
        generator = make_generator(0, device)
    cand, val, _ = _bo_step(
        state, sobol, generator, acqf_name=acqf_name, q=q,
        num_restarts=num_restarts, raw_samples=raw_samples,
        fit_restarts=fit_restarts, fit_maxiter=fit_maxiter,
        acq_maxiter=acq_maxiter, kernel=kernel, mc_samples=mc_samples,
    )
    return cand, val


def run_bo_loop(
    objective: Callable[[Tensor], Tensor],
    d: int,
    n_init: int,
    iterations: int,
    seed: int = 0,
    q: int = 1,
    capacity: Optional[int] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **step_kwargs,
) -> BOState:
    """Run `iterations` BO steps for `objective: (q, d) -> (q,)` (MAXIMIZED,
    on unit-cube inputs) on `device` (CUDA unless given). `seed` sets the
    Sobol scramble and the generator of every random draw."""
    device = resolve_device(device)
    capacity = capacity or (n_init + iterations * q)
    generator = make_generator(seed, device)
    sobol = sobol_table(q * d, scramble=True, seed=seed, device=device)
    state, X0 = init_state(n_init, d, capacity, seed=seed, device=device, dtype=dtype)
    state = append_observations(state, X0, objective(X0))
    params = make_gp(
        state.X, state.Y[:, None], kernel=step_kwargs.get("kernel", "rbf"),
        dtype=state.X.dtype, device=device,
    ).params
    for _ in range(iterations):
        cand, _, params = _bo_step(
            state, sobol, generator, q=q, params0=params, **step_kwargs
        )
        state = append_observations(state, cand, objective(cand))
    return state


def best_observed(state: BOState) -> Tensor:
    mask = torch.arange(state.X.shape[0], device=state.X.device) < state.n
    return torch.max(torch.where(mask, state.Y, -torch.inf))
