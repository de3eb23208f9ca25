r"""Acquisition-function optimization (counterpart of
`botorch_tpu/optim/optimize.py`): Sobol raw candidates, Boltzmann
initial-condition selection, then all restarts of a batched L-BFGS-B
ascent in lockstep, and the final argmax.

The acquisition function is batched: `acqf(X: (b, q, d)) -> (b,)`.
Linear (intra- and inter-point), equality and nonlinear constraints go
through an augmented-Lagrangian outer loop around the same batched solver,
each restart lane with its own multipliers, then a Dykstra polish onto the
linear feasible set and an explicit feasibility check (`optim/constraints.py`).
Not ported yet: one-shot acquisitions (ROADMAP item 19), the wall-clock
budget `timeout_sec` (item 20) and the restart sharding `shard_fn`
(item 21).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from botorch_tpu_torch.ops.lbfgs import multi_start_lbfgsb
from botorch_tpu_torch.optim.constraints import (
    FEASIBILITY_TOL,
    AffineSubspace,
    _dense_rows_flat,
    is_interpoint,
    linear_violation,
    make_al_objective,
    max_violation,
    nonlinear_values,
    project_box_affine_halfspaces,
)
from botorch_tpu_torch.sampling.sobol import draw_sobol, draw_sobol_samples
from botorch_tpu_torch.settings import make_generator, resolve_device

Tensor = torch.Tensor


def initialize_q_batch(
    generator: torch.Generator, X: Tensor, acq_vals: Tensor, n: int, eta: float = 1.0
) -> Tensor:
    """Boltzmann-weighted selection of `n` of the `b` raw q-batches without
    replacement, with probability `~ exp(eta * standardize(acq_val))`
    (Gumbel-top-k), always including the argmax."""
    b = X.shape[0]
    finite = torch.isfinite(acq_vals)
    vals = torch.where(finite, acq_vals, -torch.inf)
    max_idx = torch.argmax(vals)
    fin_vals = vals[finite]
    if fin_vals.numel() > 0:
        mean = fin_vals.mean()
        std = fin_vals.std(correction=0)
    else:
        mean = std = torch.tensor(torch.nan, dtype=vals.dtype, device=vals.device)
    std = torch.where((std > 0) & torch.isfinite(std), std, 1.0)
    mean = torch.where(torch.isfinite(mean), mean, 0.0)
    z = (vals - mean) / std
    u = torch.rand((b,), generator=generator, dtype=vals.dtype, device=vals.device)
    u = 1e-20 + (1.0 - 1e-20) * u
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(finite, eta * z + gumbel, -torch.inf)
    idcs = torch.topk(scores, n).indices
    has_max = torch.any(idcs == max_idx)
    idcs = torch.where(
        has_max | (torch.arange(n, device=idcs.device) < n - 1), idcs, max_idx
    )
    return X[idcs]


def sample_around_best(
    generator: torch.Generator,
    X_best: Tensor,
    bounds: Tensor,
    n: int,
    sigma: float = 1e-1,
) -> Tensor:
    """Truncated-normal (+-2 sd) perturbations of incumbent point(s): half
    the draws perturb all dims, half a random subset of dims."""
    kw = dict(dtype=bounds.dtype, device=bounds.device)
    d = bounds.shape[-1]
    pick = torch.randint(0, X_best.shape[0], (n,), generator=generator, device=bounds.device)
    base = X_best[pick]
    scale = sigma * (bounds[1] - bounds[0])
    lo_p = 0.5 * math.erfc(2.0 / math.sqrt(2.0))  # Phi(-2)
    u = lo_p + (1.0 - 2.0 * lo_p) * torch.rand((n, d), generator=generator, **kw)
    noise = torch.special.ndtri(u) * scale
    subset = torch.rand((n, d), generator=generator, **kw) < min(1.0, 20.0 / d)
    use_subset = torch.arange(n, device=bounds.device)[:, None] >= n // 2
    noise = torch.where(use_subset & ~subset, 0.0, noise)
    return torch.clamp(base + noise, bounds[0], bounds[1])


def gen_batch_initial_conditions(
    acqf: Callable[[Tensor], Tensor],
    bounds: Tensor,
    q: int,
    num_restarts: int,
    raw_samples: int,
    generator: torch.Generator,
    seed: int = 0,
    eta: float = 1.0,
    sobol: Optional[tuple[Tensor, Tensor]] = None,
    sobol_skip: int = 0,
    X_best: Optional[Tensor] = None,
    sample_around_best_frac: float = 0.25,
) -> Tensor:
    """Sobol raw q-batches -> acquisition values without gradient ->
    Boltzmann selection. Returns `(num_restarts, q, d)`.

    `sobol`/`sobol_skip` continue a caller's scrambled Sobol stream (the BO
    loop's), so successive iterations draw from one sequence."""
    d = bounds.shape[-1]
    if sobol is None:
        X_raw = draw_sobol_samples(bounds, raw_samples, q, seed=seed)
    else:
        sv, shift = sobol
        u = draw_sobol(sv, shift, raw_samples, skip=sobol_skip, dtype=bounds.dtype)
        # a dimension subset of a Sobol set is still a Sobol set
        u = u[:, : q * d].reshape(raw_samples, q, d)
        X_raw = bounds[0] + (bounds[1] - bounds[0]) * u
    if X_best is not None and sample_around_best_frac > 0:
        n_ab = max(int(raw_samples * sample_around_best_frac), 1)
        ab = sample_around_best(generator, torch.atleast_2d(X_best), bounds, n_ab * q)
        X_raw = torch.cat([X_raw, ab.reshape(n_ab, q, d)], dim=0)
    with torch.no_grad():
        vals = acqf(X_raw)
    return initialize_q_batch(generator, X_raw, vals, num_restarts, eta=eta)


def optimize_acqf(
    acqf: Callable[[Tensor], Tensor],
    bounds,
    q: int,
    num_restarts: int = 8,
    raw_samples: int = 128,
    generator: Optional[torch.Generator] = None,
    maxiter: int = 100,
    seed: int = 0,
    initial_conditions: Optional[Tensor] = None,
    return_full: bool = False,
    sobol: Optional[tuple[Tensor, Tensor]] = None,
    sobol_skip: int = 0,
    X_best: Optional[Tensor] = None,
    inequality_constraints: Optional[list] = None,
    equality_constraints: Optional[list] = None,
    nonlinear_inequality_constraints: Optional[list] = None,
    constraint_penalty: float = 1e3,
    ls: str = "halving",
    device=None,
):
    """Maximize `acqf` over `q` joint candidates in the box `bounds (2, d)`
    on `device` (CUDA unless given).

    `generator` drives the initial-condition selection (seeded with `seed`
    if None); `initial_conditions (r, q, d)` replaces that selection.

    Constraints, as in `optim/constraints.py`: `inequality_constraints`
    and `equality_constraints` are `(indices, coefficients, rhs)` tuples
    meaning `sum_i coef_i x[idx_i] >= rhs` (`= rhs`), per candidate for
    1-d indices and over the q-batch for 2-d `((q_i, d_i), ...)` indices;
    `nonlinear_inequality_constraints` are `g` or `(g, intra_point)`
    meaning `g >= 0`. Initial conditions then come from polytope samples
    (linear intra-point constraints), from uniform q-batches projected onto
    the equality rows and screened by their violation (inter-point), or
    from uniform q-batches screened by `constraint_penalty` times their
    squared nonlinear violation. The solve is `_optimize_constrained`: a
    restart whose candidates violate a constraint by more than
    `FEASIBILITY_TOL` gets the value `-inf`, unless no restart is feasible,
    when the least infeasible one keeps its value.

    Returns `(candidates (q, d), value)`, or with `return_full` the
    per-restart `(candidates (r, q, d), values (r,))`.
    """
    device = resolve_device(device)
    bounds = torch.as_tensor(bounds, device=device)
    if not bounds.is_floating_point():
        bounds = bounds.to(torch.float32)
    d = bounds.shape[-1]
    if generator is None:
        generator = make_generator(seed, device)
    constrained = bool(inequality_constraints or equality_constraints
                       or nonlinear_inequality_constraints)
    if initial_conditions is not None:
        ics = torch.as_tensor(initial_conditions, dtype=bounds.dtype, device=device)
        num_restarts = ics.shape[0]
    elif constrained:
        X_raw, vals = _constrained_raw_candidates(
            acqf, bounds, q, raw_samples, generator, inequality_constraints,
            equality_constraints, nonlinear_inequality_constraints, constraint_penalty,
        )
        ics = initialize_q_batch(generator, X_raw, vals, num_restarts)
    else:
        ics = gen_batch_initial_conditions(
            acqf, bounds, q, num_restarts, raw_samples, generator, seed=seed,
            sobol=sobol, sobol_skip=sobol_skip, X_best=X_best,
        )

    def neg_fun(V: Tensor) -> Tensor:
        return -acqf(V.reshape(-1, q, d))

    lo = bounds[0].repeat(q)
    hi = bounds[1].repeat(q)
    if constrained:
        cands, vals = _optimize_constrained(
            acqf, neg_fun, ics, (lo, hi), q, d, maxiter=maxiter,
            inequality_constraints=inequality_constraints,
            equality_constraints=equality_constraints,
            nonlinear_inequality_constraints=nonlinear_inequality_constraints,
        )
    else:
        res = multi_start_lbfgsb(
            neg_fun, ics.reshape(num_restarts, q * d), bounds=(lo, hi),
            maxiter=maxiter, ls=ls,
        )
        vals = torch.where(torch.isfinite(res.fun), -res.fun, -torch.inf)
        cands = res.x.reshape(num_restarts, q, d)
    if return_full:
        return cands, vals
    best = torch.argmax(vals)
    return cands[best], vals[best]


def _constrained_raw_candidates(
    acqf, bounds: Tensor, q: int, raw_samples: int, generator: torch.Generator,
    inequality_constraints, equality_constraints, nonlinear_inequality_constraints,
    constraint_penalty: float,
) -> tuple[Tensor, Tensor]:
    """Raw q-batches `(raw_samples, q, d)` for a constrained problem and the
    scores the Boltzmann selection ranks them by: the acquisition value,
    less `constraint_penalty` times a squared violation where the raw
    points may be infeasible."""
    d = bounds.shape[-1]
    kw = dict(dtype=bounds.dtype, device=bounds.device)
    interpoint = is_interpoint(inequality_constraints) or is_interpoint(equality_constraints)
    if (inequality_constraints or equality_constraints) and not interpoint:
        from botorch_tpu_torch.utils.sampling import get_polytope_samples

        pts = get_polytope_samples(generator, raw_samples * q, bounds,
                                   inequality_constraints=inequality_constraints,
                                   equality_constraints=equality_constraints)
        X_raw = pts.reshape(raw_samples, q, d)
        with torch.no_grad():
            return X_raw, acqf(X_raw)
    X_raw = bounds[0] + (bounds[1] - bounds[0]) * torch.rand(
        (raw_samples, q, d), generator=generator, **kw)
    if interpoint:
        # project onto the joint equality rows; the inequality rows are left
        # to the screening below and to the solve
        if equality_constraints:
            aff = AffineSubspace.from_dense(*_dense_rows_flat(equality_constraints, q, d),
                                            dtype=bounds.dtype, device=bounds.device)
            flat = project_box_affine_halfspaces(
                X_raw.reshape(raw_samples, q * d), bounds[0].repeat(q), bounds[1].repeat(q),
                affine=aff, iters=30,
            )
            X_raw = flat.reshape(raw_samples, q, d)
        pen = torch.square(linear_violation(X_raw, inequality_constraints, equality_constraints))
    else:
        g = nonlinear_values(X_raw, nonlinear_inequality_constraints)
        pen = torch.sum(torch.square(torch.clamp(g, max=0.0)), dim=-1)
    with torch.no_grad():
        vals = acqf(X_raw)
    return X_raw, vals - constraint_penalty * pen


def _optimize_constrained(
    acqf,
    neg_fun,
    ics: Tensor,
    box: tuple[Tensor, Tensor],
    q: int,
    d: int,
    maxiter: int,
    inequality_constraints=None,
    equality_constraints=None,
    nonlinear_inequality_constraints=None,
    al_rounds: int = 4,
    rho0: float = 10.0,
    rho_growth: float = 10.0,
):
    """Augmented-Lagrangian multi-start solve, feasibility polish and check.

    `al_rounds` rounds of the batched L-BFGS-B, `max(maxiter // al_rounds,
    10)` iterations each, on the AL objective with per-lane multipliers
    `lam (r, n_eq)` and `mu (r, n_ineq)`, updated after each round from that
    lane's own constraint values; the penalty `rho` grows by `rho_growth`.
    Then Dykstra's projection onto the linear feasible set in the flattened
    `(q * d)` space (inter-point rows included). Returns `(cands (r, q, d),
    vals (r,))`, infeasible restarts at `-inf` unless none is feasible, when
    the least infeasible keeps its value."""
    lo, hi = box
    r = ics.shape[0]
    kw = dict(dtype=ics.dtype, device=ics.device)
    al_obj, n_eq, n_ineq, constraint_vals = make_al_objective(
        neg_fun, q, d,
        inequality_constraints=inequality_constraints,
        equality_constraints=equality_constraints,
        nonlinear_inequality_constraints=nonlinear_inequality_constraints,
        dtype=ics.dtype, device=ics.device,
    )
    x = ics.reshape(r, q * d)
    lam = torch.zeros((r, n_eq), **kw)
    mu = torch.zeros((r, n_ineq), **kw)
    inner = max(maxiter // al_rounds, 10)
    rho = rho0
    for _ in range(al_rounds):
        x = multi_start_lbfgsb(
            lambda V, lam=lam, mu=mu, rho=rho: al_obj(V, lam, mu, rho), x,
            bounds=(lo, hi), maxiter=inner,
        ).x
        with torch.no_grad():
            h, c = constraint_vals(x)
        lam = lam + rho * h
        mu = torch.clamp(mu - rho * c, min=0.0)
        rho = rho * rho_growth

    if inequality_constraints or equality_constraints:
        affine = None
        if equality_constraints:
            affine = AffineSubspace.from_dense(*_dense_rows_flat(equality_constraints, q, d),
                                               dtype=ics.dtype, device=ics.device)
        A_ineq = b_ineq = None
        if inequality_constraints:
            A_np, b_np = _dense_rows_flat(inequality_constraints, q, d)
            A_ineq = torch.as_tensor(A_np, **kw)
            b_ineq = torch.as_tensor(b_np, **kw)
        x = project_box_affine_halfspaces(x, lo, hi, affine=affine, A_ineq=A_ineq, b_ineq=b_ineq)
    cands = x.reshape(r, q, d)
    with torch.no_grad():
        vals = acqf(cands)
        vals = torch.where(torch.isfinite(vals), vals, -torch.inf)
        viol = max_violation(cands, inequality_constraints, equality_constraints,
                             nonlinear_inequality_constraints)
    feasible = viol <= FEASIBILITY_TOL
    most_feasible = torch.arange(r, device=ics.device) == torch.argmin(viol)
    keep = torch.where(torch.any(feasible), feasible, most_feasible)
    return cands, torch.where(keep, vals, -torch.inf)
