r"""Acquisition-function optimization, unconstrained path (counterpart of
`botorch_tpu/optim/optimize.py`): Sobol raw candidates, Boltzmann
initial-condition selection, then all restarts of a batched L-BFGS-B
ascent in lockstep, and the final argmax.

The acquisition function is batched: `acqf(X: (b, q, d)) -> (b,)`.
Linear and nonlinear constraints, one-shot acquisitions and the wall-clock
budget are not part of this port yet.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from botorch_tpu_torch.ops.lbfgs import multi_start_lbfgsb
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
    ls: str = "halving",
    device=None,
):
    """Maximize `acqf` over `q` joint candidates in the box `bounds (2, d)`
    on `device` (CUDA unless given).

    `generator` drives the initial-condition selection (seeded with `seed`
    if None); `initial_conditions (r, q, d)` replaces that selection.
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
    if initial_conditions is None:
        ics = gen_batch_initial_conditions(
            acqf, bounds, q, num_restarts, raw_samples, generator, seed=seed,
            sobol=sobol, sobol_skip=sobol_skip, X_best=X_best,
        )
    else:
        ics = torch.as_tensor(initial_conditions, dtype=bounds.dtype, device=device)
        num_restarts = ics.shape[0]

    def neg_fun(V: Tensor) -> Tensor:
        return -acqf(V.reshape(-1, q, d))

    lo = bounds[0].repeat(q)
    hi = bounds[1].repeat(q)
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
