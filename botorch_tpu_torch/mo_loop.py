r"""Closed-loop MULTI-OBJECTIVE Bayesian optimization (counterpart of
`botorch_tpu/mo_loop.py`): qLogNEHVI over a padded history, two objectives.

The design is `loop.py`'s: the history lives in fixed-size padded buffers
with a validity mask, each iteration fits a multi-output GP (warm-started
from the previous iteration's MAP estimate), builds qLogNEHVI over the
padded baseline with fresh qMC base samples, maximizes it and appends the
evaluated candidates. The padded baseline enters qLogNEHVI through its
`baseline_mask`: masked rows move strictly below the reference point, so
they add no cell to the per-sample fronts. PyTorch runs eagerly: the loop
is a Python loop, on the chosen device (CUDA unless given).

Entry points:
  * `mo_bo_step`: one fit + acquire + optimize step for an external
    objective; the caller evaluates and calls `append_mo_observations`.
  * `run_mo_bo_loop`: the whole loop for an objective on tensors.
  * `observed_hypervolume`: the hypervolume of the observed front.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from botorch_tpu_torch.acquisition.monte_carlo import draw_fresh_base_samples
from botorch_tpu_torch.acquisition.multi_objective import (
    _subset_masks,
    make_in_graph_nehvi_cells,
    qLogNoisyExpectedHypervolumeImprovement,
)
from botorch_tpu_torch.fit import fit_gp
from botorch_tpu_torch.loop import init_state
from botorch_tpu_torch.models.gp import GPParams, make_gp
from botorch_tpu_torch.optim.optimize import optimize_acqf
from botorch_tpu_torch.sampling.sobol import sobol_table
from botorch_tpu_torch.settings import make_generator, resolve_device
from botorch_tpu_torch.utils.multi_objective import hypervolume

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
# Sobol seed of the qLogNEHVI base samples (each step XORs a fresh shift in)
_BASE_SAMPLES_SEED = 23


@dataclass(frozen=True)
class MOBOState:
    """Padded multi-objective BO history in the unit cube; `n` is the
    number of valid rows."""

    X: Tensor  # (N_max, d)
    Y: Tensor  # (N_max, m) observations (original units)
    n: int


def init_mo_state(
    n_init: int, d: int, m: int, capacity: int, seed: int = 0, device=None, dtype=None
) -> tuple[MOBOState, Tensor]:
    """Scrambled-Sobol initial design; the same contract as
    `loop.init_state` (Y zeros until `append_mo_observations`)."""
    so_state, X0 = init_state(n_init, d, capacity, seed=seed, device=device, dtype=dtype)
    Y = torch.zeros((capacity, m), dtype=so_state.X.dtype, device=so_state.X.device)
    return MOBOState(X=so_state.X, Y=Y, n=0), X0


def append_mo_observations(state: MOBOState, X_new: Tensor, Y_new: Tensor) -> MOBOState:
    """Write a `(q, d)` block and its `(q, m)` observations at the fill
    point."""
    q = X_new.shape[0]
    if state.n + q > state.X.shape[0]:
        raise ValueError(f"state is full: capacity {state.X.shape[0]}")
    X = state.X.clone()
    Y = state.Y.clone()
    X[state.n:state.n + q] = X_new.to(X.dtype)
    Y[state.n:state.n + q] = Y_new.to(Y.dtype)
    return MOBOState(X=X, Y=Y, n=state.n + q)


def _qlognehvi(model, cache, state: MOBOState, base: Tensor, ref_point: Tensor, cells,
               n_cand: int, X_pending: Optional[Tensor] = None):
    """qLogNEHVI of `n_cand` joint candidates (the last `X_pending.shape[0]`
    of them pending) over the padded history: the first `capacity + n_cand`
    rows of the base samples, the per-sample `cells` of the baseline."""
    capacity = state.X.shape[0]
    mask = torch.arange(capacity, device=state.X.device) < state.n
    masks, signs = _subset_masks(n_cand, device=state.X.device)
    return qLogNoisyExpectedHypervolumeImprovement(
        model=model, cache=cache, base_samples=base[:, :capacity + n_cand, :],
        X_baseline=state.X, ref_point=ref_point, masks=masks, signs=signs, baseline_mask=mask,
        cell_lower=cells[0], cell_upper=cells[1], X_pending=X_pending,
    )


def _mo_bo_step(
    state: MOBOState,
    sobol: tuple[Tensor, Tensor],
    generator: torch.Generator,
    ref_point,
    q: int = 1,
    num_restarts: int = 8,
    raw_samples: int = 64,
    fit_restarts: int = 2,
    fit_maxiter: int = 20,
    acq_maxiter: int = 20,
    kernel: str = "rbf",
    mc_samples: int = 64,
    params0: Optional[GPParams] = None,
    sequential: bool = True,
    fit_x0: Optional[Tensor] = None,
    initial_conditions=None,
    base_samples: Optional[Tensor] = None,
):
    """One MO BO iteration on the padded state: MAP-fit the multi-output GP
    on the masked history, build qLogNEHVI over the padded baseline,
    maximize it in the unit cube.

    With `sequential` and q > 1 the q-batch is built greedily: pick j
    maximizes the joint HVI of one candidate with the j earlier picks as
    `X_pending`, from Sobol points `j * raw_samples` further along the
    stream; otherwise the q candidates are optimized jointly. Both use the
    interpolating line search.

    Returns `(candidates (q, d), value of the last optimization, fitted
    GPParams)`. `params0` warm-starts restart 0 of the fit; `fit_x0`,
    `initial_conditions` and `base_samples` (`(mc_samples, capacity + q,
    m)`) replace the fit's restart starts, the acquisition's initial
    conditions (one `(num_restarts, 1, d)` block per pick when sequential,
    else `(num_restarts, q, d)`) and the base samples, drawn from
    `generator` otherwise."""
    device = state.X.device
    capacity, d = state.X.shape
    m = state.Y.shape[-1]
    mask = torch.arange(capacity, device=device) < state.n
    model = make_gp(state.X, state.Y, mask=mask, kernel=kernel, dtype=state.X.dtype, device=device)
    if params0 is not None:
        model = model.replace(params=params0)
    model = fit_gp(model, generator, num_restarts=fit_restarts, maxiter=fit_maxiter, x0=fit_x0,
                   device=device)
    if base_samples is None:
        base_samples = draw_fresh_base_samples(capacity + q, m, mc_samples, generator,
                                               seed=_BASE_SAMPLES_SEED)
    base = torch.as_tensor(base_samples, device=device)
    cache = model.train_chol()
    ref_point = torch.as_tensor(ref_point, dtype=state.X.dtype, device=device)
    unit_bounds = torch.stack(
        [torch.zeros(d, dtype=state.X.dtype, device=device),
         torch.ones(d, dtype=state.X.dtype, device=device)]
    )
    skip = (state.n + 1) * raw_samples
    # The per-sample cells come from the baseline block of the SAA samples,
    # which no candidate changes (pending points enter as candidates), so
    # one decomposition serves every pick and every evaluation.
    cells = make_in_graph_nehvi_cells(model, cache, state.X, base[:, :capacity, :], ref_point,
                                      baseline_mask=mask)
    opt = dict(num_restarts=num_restarts, raw_samples=raw_samples, generator=generator,
               maxiter=acq_maxiter, sobol=sobol, ls="interp", device=device)
    if sequential and q > 1:
        cands, val = [], None
        for j in range(q):
            pending = torch.cat(cands, dim=0) if cands else None
            ics = None if initial_conditions is None else initial_conditions[j]
            cand_j, val = optimize_acqf(
                _qlognehvi(model, cache, state, base, ref_point, cells, 1 + j, pending),
                unit_bounds, q=1, initial_conditions=ics,
                sobol_skip=(skip + j * raw_samples) & _MASK32, **opt,
            )
            cands.append(cand_j)
        return torch.cat(cands, dim=0), val, model.params
    acqf = _qlognehvi(model, cache, state, base, ref_point, cells, q)
    cand, val = optimize_acqf(acqf, unit_bounds, q=q,
                              initial_conditions=initial_conditions, sobol_skip=skip & _MASK32,
                              **opt)
    return cand, val, model.params


def mo_bo_step(
    state: MOBOState,
    sobol: tuple[Tensor, Tensor],
    ref_point,
    generator: Optional[torch.Generator] = None,
    q: int = 1,
    num_restarts: int = 8,
    raw_samples: int = 64,
    fit_restarts: int = 2,
    fit_maxiter: int = 20,
    acq_maxiter: int = 20,
    kernel: str = "rbf",
    mc_samples: int = 64,
    sequential: bool = True,
    device=None,
) -> tuple[Tensor, Tensor]:
    """Public single step (see `_mo_bo_step`) on `device` (CUDA unless
    given); returns `(candidates (q, d), acq_value)`."""
    device = resolve_device(device)
    state = MOBOState(X=state.X.to(device), Y=state.Y.to(device), n=state.n)
    sobol = (sobol[0].to(device), sobol[1].to(device))
    if generator is None:
        generator = make_generator(0, device)
    cand, val, _ = _mo_bo_step(
        state, sobol, generator, ref_point, q=q, num_restarts=num_restarts,
        raw_samples=raw_samples, fit_restarts=fit_restarts, fit_maxiter=fit_maxiter,
        acq_maxiter=acq_maxiter, kernel=kernel, mc_samples=mc_samples, sequential=sequential,
    )
    return cand, val


def run_mo_bo_loop(
    objective: Callable[[Tensor], Tensor],
    d: int,
    m: int,
    ref_point,
    n_init: int,
    iterations: int,
    seed: int = 0,
    q: int = 1,
    capacity: Optional[int] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **step_kwargs,
) -> MOBOState:
    """Run `iterations` MO BO steps for `objective: (q, d) -> (q, m)` (all
    objectives MAXIMIZED, unit-cube inputs) on `device` (CUDA unless
    given). `seed` sets the Sobol scramble and the generator of every
    random draw; each fit warm-starts from the previous one."""
    device = resolve_device(device)
    capacity = capacity or (n_init + iterations * q)
    generator = make_generator(seed, device)
    sobol = sobol_table(q * d, scramble=True, seed=seed, device=device)
    state, X0 = init_mo_state(n_init, d, m, capacity, seed=seed, device=device, dtype=dtype)
    state = append_mo_observations(state, X0, objective(X0))
    params = make_gp(state.X, state.Y, kernel=step_kwargs.get("kernel", "rbf"),
                     dtype=state.X.dtype, device=device).params
    for _ in range(iterations):
        cand, _, params = _mo_bo_step(
            state, sobol, generator, ref_point, q=q, params0=params, **step_kwargs
        )
        state = append_mo_observations(state, cand, objective(cand))
    return state


def observed_hypervolume(state: MOBOState, ref_point) -> float:
    """Hypervolume of the observed front above `ref_point` (dominated and
    not-above-`ref` points add nothing)."""
    return hypervolume(state.Y[: state.n], torch.as_tensor(ref_point))
