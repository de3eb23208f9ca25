r"""Candidate generation by sampling from a discrete set (counterpart of
`botorch_tpu/generation/sampling.py`): Thompson sampling without an inner
optimizer, the workhorse of TuRBO loops.

Two posterior-sampling backends:
  * `joint`: draws from the exact joint posterior over the candidate set
    (a `n_c x n_c` factorization, for small sets);
  * `pathwise`: Matheron sample paths evaluated at the candidates
    (`sampling/pathwise.py`, for TuRBO-sized sets).

Every draw comes from an explicit `torch.Generator`, or is passed in:
`PathDraws` for the pathwise backend, base samples for the joint one,
Gumbel noise for `boltzmann_sampling`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from botorch_tpu_torch.sampling.pathwise import PathDraws, draw_matheron_paths

Tensor = torch.Tensor


def _joint_draws(post, generator, num_samples: int, base_samples: Optional[Tensor]) -> Tensor:
    if base_samples is None:
        return post.rsample(generator, (num_samples,))
    return post.rsample_from_base_samples(base_samples)


def max_posterior_sampling(
    model,
    X_cand: Tensor,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 1,
    observation_noise: bool = False,
    maximize: bool = True,
    method: str = "pathwise",
    num_features: int = 1024,
    draws: Union[PathDraws, Tensor, None] = None,
) -> Tensor:
    """Thompson sampling over `X_cand (n_c, d)`: draw `num_samples`
    posterior functions and return each one's argmax candidate,
    `(num_samples, d)`. `draws` replaces the draws from `generator`:
    `PathDraws` (pathwise) or base samples `(num_samples, n_c, 1)` (joint)."""
    if method == "pathwise":
        paths = draw_matheron_paths(model, generator, num_samples, num_features, draws=draws)
        vals = paths(X_cand)  # (num_samples, n_c)
    else:
        post = model.posterior(X_cand, observation_noise=observation_noise)
        vals = _joint_draws(post, generator, num_samples, draws)[..., 0]  # (num_samples, n_c)
    if not maximize:
        vals = -vals
    return X_cand[torch.argmax(vals, dim=-1)]


def constrained_max_posterior_sampling(
    model,
    constraint_model,
    X_cand: Tensor,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 1,
    base_samples: Optional[tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """Thompson sampling with feasibility from `constraint_model` (`c(x)
    <= 0` is feasible): infeasible candidates score -inf; a sample with no
    feasible candidate takes the one of least total violation.
    `base_samples` is the pair of the objective's `(s, n_c, 1)` and the
    constraints' `(s, n_c, m_c)` joint base samples."""
    obj_base, con_base = (None, None) if base_samples is None else base_samples
    obj = _joint_draws(model.posterior(X_cand), generator, num_samples, obj_base)[..., 0]
    cons = _joint_draws(constraint_model.posterior(X_cand), generator, num_samples, con_base)
    violation = torch.sum(torch.clamp(cons, min=0.0), dim=-1)  # (s, n_c)
    feasible = torch.all(cons <= 0, dim=-1)
    any_feas = torch.any(feasible, dim=-1, keepdim=True)
    score = torch.where(any_feas, torch.where(feasible, obj, -torch.inf), -violation)
    return X_cand[torch.argmax(score, dim=-1)]


def boltzmann_sampling(
    acq_vals: Tensor,
    X_cand: Tensor,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 1,
    eta: float = 1.0,
    replacement: bool = True,
    gumbel: Optional[Tensor] = None,
) -> Tensor:
    """Sample candidates with probability `~ exp(eta * standardize(val))`
    by the Gumbel-max trick (with replacement) or Gumbel top-k (without).
    Non-finite values are never picked and are left out of the
    standardization (population std, as `jnp.std`). `gumbel` replaces the
    Gumbel noise from `generator`: `(num_samples, n_c)` with replacement,
    `(n_c,)` without."""
    finite = torch.isfinite(acq_vals)
    vals = torch.where(finite, acq_vals, -torch.inf)
    count = torch.sum(finite)
    mean = torch.sum(torch.where(finite, vals, 0.0)) / count
    std = torch.sqrt(torch.sum(torch.where(finite, torch.square(vals - mean), 0.0)) / count)
    std = torch.where((std > 0) & torch.isfinite(std), std, 1.0)
    logits = torch.where(finite, eta * (vals - mean) / std, -torch.inf)
    shape = (num_samples, *logits.shape) if replacement else logits.shape
    if gumbel is None:
        tiny = torch.finfo(logits.dtype).tiny
        u = torch.rand(shape, generator=generator, dtype=logits.dtype, device=logits.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if replacement:
        idx = torch.argmax(logits + gumbel, dim=-1)
    else:
        idx = torch.topk(logits + gumbel, num_samples).indices
    return X_cand[idx]


@dataclass(frozen=True)
class PathwiseThompsonSampling:
    """Thompson sampling as an acquisition function: the q-sum of one
    fixed pathwise posterior draw, so maximizing it with `optimize_acqf`
    gives a Thompson sample. `X (..., q, d) -> (...)`. Build with
    `make_pathwise_thompson_sampling`."""

    paths: object  # MatheronPath or SVGPMatheronPath with one path

    def __call__(self, X: Tensor) -> Tensor:
        return torch.sum(self.paths(torch.atleast_2d(X))[0], dim=-1)


def make_pathwise_thompson_sampling(
    model, generator: Optional[torch.Generator] = None, num_features: int = 1024,
    draws: Optional[PathDraws] = None,
) -> PathwiseThompsonSampling:
    """Draw one Matheron path and wrap it as an acquisition function."""
    if getattr(model, "_is_fully_bayesian", False):
        raise NotImplementedError(
            "PathwiseThompsonSampling is not supported for fully Bayesian "
            "models (as in the reference)"
        )
    paths = draw_matheron_paths(model, generator, num_paths=1, num_features=num_features,
                                draws=draws)
    return PathwiseThompsonSampling(paths=paths)
