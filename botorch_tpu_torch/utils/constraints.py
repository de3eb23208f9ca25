r"""Outcome-constraint helpers (counterpart of `botorch_tpu/utils/constraints.py`).

An outcome constraint is a callable `c(samples) -> values` over the last
(output) dim of `samples`, feasible where `c <= 0`. The MC acquisitions
weight their improvement by the smoothed indicator defined here
(`smoothed_feasibility_log_indicator`, the one definition the port has).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from botorch_tpu_torch.utils import safe_math as sm

Tensor = torch.Tensor


def get_outcome_constraint_transforms(
    outcome_constraints: Optional[tuple],
) -> Optional[list[Callable[[Tensor], Tensor]]]:
    """`(A (k, m), b (k,) or (k, 1))` with `A Y <= b` row-wise -> callables
    `c_i(samples) = a_i . samples - b_i` (feasible iff `c_i <= 0`)."""
    if outcome_constraints is None:
        return None
    A, b = (torch.as_tensor(t) for t in outcome_constraints)
    b = b.reshape(-1)

    def make(i):
        return lambda samples: torch.sum(samples * A[i].to(samples), dim=-1) - b[i].to(samples)

    return [make(i) for i in range(A.shape[0])]


def get_monotonicity_constraints(
    d: int, descending: bool = False, dtype=torch.float32, device=None
) -> tuple[Tensor, Tensor]:
    """`(A (d-1, d), b (d-1, 1))` with `A x <= b` encoding `x_1 <= ... <= x_d`
    (or descending)."""
    kw = dict(dtype=dtype, device=device)
    A = torch.eye(d - 1, d, **kw) - torch.eye(d - 1, d, **kw).roll(1, dims=-1)
    if descending:
        A = -A
    return A, torch.zeros((d - 1, 1), **kw)


def smoothed_feasibility_log_indicator(
    constraints: Sequence[Callable[[Tensor], Tensor]],
    samples: Tensor,
    eta: Union[float, Sequence[float], Tensor] = 1e-3,
    fat: bool = False,
) -> Tensor:
    """`sum_i log s(-c_i(samples) / eta_i)`: the log of the product of smooth
    feasibility steps, the sigmoid `s` or, with `fat`, the fat-tailed one.
    `eta` is one temperature or one per constraint."""
    step = sm.log_fatmoid if fat else sm.logexpit
    etas = [eta] * len(constraints) if torch.as_tensor(eta).ndim == 0 else list(eta)
    total = 0.0
    for c, e in zip(constraints, etas):
        total = total + step(-c(samples) / e)
    return total


def compute_smoothed_feasibility_indicator(
    constraints: Sequence[Callable[[Tensor], Tensor]],
    samples: Tensor,
    eta: Union[float, Sequence[float], Tensor] = 1e-3,
    log: bool = False,
) -> Tensor:
    """Product of sigmoid feasibility indicators `prod_i s(-c_i/eta_i)` (its
    log with `log=True`)."""
    total = smoothed_feasibility_log_indicator(constraints, samples, eta)
    return total if log else torch.exp(total)


def compute_feasibility_indicator(
    constraints: Optional[Sequence[Callable[[Tensor], Tensor]]],
    samples: Tensor,
) -> Tensor:
    """Hard feasibility `all_i c_i(samples) <= 0`, shape `samples.shape[:-1]`."""
    feas = torch.ones(samples.shape[:-1], dtype=torch.bool, device=samples.device)
    for c in constraints or ():
        feas = feas & (c(samples) <= 0)
    return feas


def apply_constraints_nonnegative_soft(
    obj: Tensor,
    constraints: Sequence[Callable[[Tensor], Tensor]],
    samples: Tensor,
    eta: Union[float, Sequence[float], Tensor],
) -> Tensor:
    """Clamp the objective at 0 and weight it by the smoothed feasibility."""
    w = compute_smoothed_feasibility_indicator(constraints, samples, eta)
    if obj.ndim == samples.ndim:
        w = w[..., None]
    return sm.maximum(obj, 0.0) * w


def apply_constraints(
    obj: Tensor,
    constraints: Sequence[Callable[[Tensor], Tensor]],
    samples: Tensor,
    infeasible_cost: float,
    eta: Union[float, Sequence[float], Tensor] = 1e-3,
) -> Tensor:
    """`w * (obj + M) - M` with `M = infeasible_cost` and `w` the smoothed
    feasibility: infeasible samples go to `-M`."""
    obj = apply_constraints_nonnegative_soft(obj + infeasible_cost, constraints, samples, eta)
    return obj - infeasible_cost


def estimate_feasible_volume(
    model,
    bounds: Tensor,
    constraints: Sequence[Callable[[Tensor], Tensor]],
    generator: Optional[torch.Generator] = None,
    num_points: int = 4096,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """Monte-Carlo fraction of the box `bounds (2, d)` where the posterior
    mean satisfies every outcome constraint, at `num_points` uniform points
    drawn from `generator` or given as `uniforms (num_points, d)` in
    `[0, 1)`."""
    if uniforms is None:
        if generator is None:
            raise ValueError("estimate_feasible_volume needs a generator or uniforms")
        uniforms = torch.rand((num_points, bounds.shape[-1]), generator=generator,
                              dtype=bounds.dtype, device=bounds.device)
    X = bounds[0] + (bounds[1] - bounds[0]) * uniforms.to(bounds)
    mean = model.posterior(X).mean  # (N, m)
    return torch.mean(compute_feasibility_indicator(constraints, mean).to(bounds.dtype))
