r"""Analytic acquisition functions for Gaussian posteriors (counterpart of
`botorch_tpu/acquisition/analytic.py`): EI, LogEI, PI, LogPI, UCB and
PosteriorMean, the classes of the BO loop's `_ANALYTIC` table, and the
constrained (Log)EI of independent outputs.

Each acquisition function is a dataclass holding the fitted model and its
train cache (`model.train_chol()`), so every evaluation reuses one
factorization. `__call__` follows BoTorch's t-batch contract, where the JAX
package used `vmap`: `X: (b, q, d)` with `q = 1` maps to values `(b,)`.

A fully-Bayesian model carries an ensemble `model.batch_shape` (the `S`
MCMC draws). Its dims go after the t-batch (`X` becomes `(b, 1, 1, d)`
for `S`), so a posterior moment is `(b, S)`, and `reduce_ensemble` takes
the mean (logmeanexp for the log classes) over `S` alone: one
candidate's value never depends on the rest of the batch, as under the
JAX package's per-candidate `vmap`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from botorch_tpu_torch.models.gp import SingleTaskGP
from botorch_tpu_torch.utils.probability import (
    ei_helper,
    log_ei_helper,
    log_ndtr,
    log_prob_normal_in,
    ndtr,
)
from botorch_tpu_torch.utils.safe_math import logmeanexp, maximum

Tensor = torch.Tensor

_MIN_VAR = 1e-12


def reduce_ensemble(val: Tensor, ndims: int, log: bool = False) -> Tensor:
    """Average `val` over its trailing `ndims` ensemble dims: the mean for
    linear acquisitions, logmeanexp for log ones. No-op for `ndims = 0`."""
    if ndims == 0:
        return val
    dims = tuple(range(-ndims, 0))
    return logmeanexp(val, dim=dims) if log else torch.mean(val, dim=dims)


@dataclass(kw_only=True)
class AnalyticAcquisitionFunction:
    """Shared machinery: marginal posterior moments at single points."""

    model: SingleTaskGP
    cache: tuple  # (L, alpha, Linv) from model.train_chol()
    maximize: bool = True

    def _mean_and_sigma(self, X: Tensor) -> tuple[Tensor, Tensor]:
        """Posterior mean and stddev at `X: (b, 1, d)` -> `(b, *ensemble)`
        each; the ensemble dims are inserted after the t-batch."""
        ens = len(self.model.batch_shape)
        X = X.reshape(*X.shape[:-2], *(1,) * ens, *X.shape[-2:])
        post = self.model.posterior(X, cache=self.cache)
        mean = post.mean[..., 0, 0]
        sigma = torch.sqrt(maximum(post.variance[..., 0, 0], _MIN_VAR))
        return mean, sigma

    def _reduce(self, val: Tensor, log: bool = False) -> Tensor:
        return reduce_ensemble(val, len(self.model.batch_shape), log)

    def _u(self, X: Tensor, best_f) -> tuple[Tensor, Tensor]:
        mean, sigma = self._mean_and_sigma(X)
        u = (mean - best_f) / sigma
        return (u if self.maximize else -u), sigma


@dataclass(kw_only=True)
class ExpectedImprovement(AnalyticAcquisitionFunction):
    """`EI(x) = sigma * (phi(u) + u Phi(u))`, `u = (mu - best_f)/sigma`."""

    best_f: Union[Tensor, float] = 0.0

    def __call__(self, X: Tensor) -> Tensor:
        u, sigma = self._u(X, self.best_f)
        return self._reduce(sigma * ei_helper(u))


@dataclass(kw_only=True)
class LogExpectedImprovement(AnalyticAcquisitionFunction):
    """`log EI(x)`, numerically robust far from the incumbent
    [Ament2023logei]."""

    best_f: Union[Tensor, float] = 0.0

    def __call__(self, X: Tensor) -> Tensor:
        u, sigma = self._u(X, self.best_f)
        return self._reduce(log_ei_helper(u) + torch.log(sigma), log=True)


@dataclass(kw_only=True)
class ProbabilityOfImprovement(AnalyticAcquisitionFunction):
    """`PI(x) = Phi((mu - best_f)/sigma)`."""

    best_f: Union[Tensor, float] = 0.0

    def __call__(self, X: Tensor) -> Tensor:
        u, _ = self._u(X, self.best_f)
        return self._reduce(ndtr(u))


@dataclass(kw_only=True)
class LogProbabilityOfImprovement(AnalyticAcquisitionFunction):
    """`log PI(x)` via the stable `log_ndtr`."""

    best_f: Union[Tensor, float] = 0.0

    def __call__(self, X: Tensor) -> Tensor:
        u, _ = self._u(X, self.best_f)
        return self._reduce(log_ndtr(u), log=True)


@dataclass(kw_only=True)
class UpperConfidenceBound(AnalyticAcquisitionFunction):
    """`UCB(x) = mu + sqrt(beta) * sigma`."""

    beta: Union[Tensor, float] = 0.25

    def __call__(self, X: Tensor) -> Tensor:
        mean, sigma = self._mean_and_sigma(X)
        delta = torch.sqrt(torch.as_tensor(self.beta, dtype=sigma.dtype, device=sigma.device)) * sigma
        return self._reduce(mean + delta if self.maximize else -(mean - delta))


@dataclass(kw_only=True)
class PosteriorMean(AnalyticAcquisitionFunction):
    """Posterior mean (negated when minimizing)."""

    def __call__(self, X: Tensor) -> Tensor:
        mean, _ = self._mean_and_sigma(X)
        return self._reduce(mean if self.maximize else -mean)


@dataclass(kw_only=True)
class ConstrainedAnalyticBase(AnalyticAcquisitionFunction):
    """Feasibility weighting over independent outputs: output
    `objective_index` is the objective, every other output `i` is
    constrained to `[constraint_lower[i], constraint_upper[i]]`, with `-inf`
    or `inf` leaving that side open (two-sided, lower-only and upper-only
    cases). `X: (b, 1, d)` gives `(b,)`; an ensemble model is not taken."""

    best_f: Union[Tensor, float] = 0.0
    constraint_lower: Tensor  # (m,)
    constraint_upper: Tensor  # (m,)
    objective_index: int = 0

    def __post_init__(self):
        if self.model.batch_shape:
            raise NotImplementedError(
                "constrained analytic acquisition over an ensemble is not ported (the JAX "
                "package does not reduce the ensemble here either)"
            )

    def _moments(self, X: Tensor) -> tuple[Tensor, Tensor]:
        post = self.model.posterior(X, cache=self.cache)
        means = post.mean[..., 0, :]  # (b, m)
        sigmas = torch.sqrt(maximum(post.variance[..., 0, :], _MIN_VAR))
        return means, sigmas

    def _log_prob_feas(self, means: Tensor, sigmas: Tensor) -> Tensor:
        """`sum_i log P(lower_i <= y_i <= upper_i)` over the constrained
        outputs. The values are the JAX package's; an infinite bound is
        replaced by 0 before it is standardized, so no branch sees `inf`
        and the gradient stays finite (the JAX package's is NaN wherever a
        bound is infinite, the objective's column included)."""
        lower = torch.as_tensor(self.constraint_lower).to(means)
        upper = torch.as_tensor(self.constraint_upper).to(means)
        m = means.shape[-1]
        has_lo, has_hi = torch.isfinite(lower), torch.isfinite(upper)
        constrained = (torch.arange(m, device=means.device) != self.objective_index) & (
            has_lo | has_hi)
        lo = (torch.where(has_lo, lower, 0.0) - means) / sigmas
        hi = (torch.where(has_hi, upper, 0.0) - means) / sigmas
        two_sided = has_lo & has_hi
        lp = torch.where(
            two_sided,
            log_prob_normal_in(torch.where(two_sided, lo, -1.0), torch.where(two_sided, hi, 1.0)),
            torch.where(has_lo, log_ndtr(-lo), log_ndtr(hi)),
        )
        return torch.sum(torch.where(constrained, lp, 0.0), dim=-1)

    def _u(self, X: Tensor, best_f) -> tuple[Tensor, Tensor, Tensor]:
        means, sigmas = self._moments(X)
        i = self.objective_index
        u = (means[..., i] - best_f) / sigmas[..., i]
        return (u if self.maximize else -u), sigmas[..., i], self._log_prob_feas(means, sigmas)


@dataclass(kw_only=True)
class LogConstrainedExpectedImprovement(ConstrainedAnalyticBase):
    """`log EI(x) + sum_i log P(feasible_i)`."""

    def __call__(self, X: Tensor) -> Tensor:
        u, sigma, log_feas = self._u(X, self.best_f)
        return log_ei_helper(u) + torch.log(sigma) + log_feas


@dataclass(kw_only=True)
class ConstrainedExpectedImprovement(ConstrainedAnalyticBase):
    """`EI(x) * prod_i P(feasible_i)`."""

    def __call__(self, X: Tensor) -> Tensor:
        u, sigma, log_feas = self._u(X, self.best_f)
        return sigma * ei_helper(u) * torch.exp(log_feas)


ANALYTIC = {
    "EI": ExpectedImprovement,
    "LogEI": LogExpectedImprovement,
    "PI": ProbabilityOfImprovement,
    "LogPI": LogProbabilityOfImprovement,
    "UCB": UpperConfidenceBound,
    "PosteriorMean": PosteriorMean,
}


def make_acqf(name: str, model: SingleTaskGP, **kwargs):
    """String-keyed factory; the train cache is computed here once."""
    return ANALYTIC[name](model=model, cache=model.train_chol(), **kwargs)
