r"""Gaussian-mixture posterior helpers for fully-Bayesian (ensemble) GPs
(counterpart of `botorch_tpu/posteriors/fully_bayesian.py`).

A fully-Bayesian model's posterior is a uniform mixture over its MCMC
draws: an ordinary `GaussianPosterior` whose `mcmc_axis` is the ensemble
dim. These helpers give the mixture's exact moments, and its marginal
quantiles by bisection on the mixture CDF, elementwise over `(q, m)`.
Variances over the ensemble divide by `S` (the population variance), as
`jnp.var` does.
"""

from __future__ import annotations

import torch

from botorch_tpu_torch.utils.probability import ndtr

Tensor = torch.Tensor


def mixture_mean(posterior, mcmc_axis: int = 0) -> Tensor:
    """`E[y] = mean_s mu_s` over the ensemble dim."""
    return torch.mean(posterior.mean, dim=mcmc_axis)


def mixture_variance(posterior, mcmc_axis: int = 0) -> Tensor:
    """Law of total variance: `mean_s sigma_s^2 + var_s(mu_s)`."""
    return torch.mean(posterior.variance, dim=mcmc_axis) + torch.var(
        posterior.mean, dim=mcmc_axis, correction=0
    )


def mixture_covariance(posterior, mcmc_axis: int = 0) -> Tensor:
    """Total covariance over the q-block, `mean_s cov_s + cov_s(mu_s)`, per
    output: `(..., m, q, q)`."""
    cov = torch.mean(posterior.cov, dim=mcmc_axis)
    mu = torch.movedim(posterior.mean, mcmc_axis, 0).transpose(-1, -2)  # (S, ..., m, q)
    resid = mu - torch.mean(mu, dim=0)
    return cov + torch.mean(resid[..., :, None] * resid[..., None, :], dim=0)


def mixture_quantile(posterior, q_level, mcmc_axis: int = 0, num_iters: int = 60) -> Tensor:
    """Marginal quantiles of the mixture: `num_iters` bisection steps on
    `F(y) = mean_s Phi((y - mu_s) / sigma_s)` from the bracket
    `[min_s mu_s - 6 sigma_s, max_s mu_s + 6 sigma_s]`."""
    mu = torch.movedim(posterior.mean, mcmc_axis, 0)  # (S, ..., q, m)
    sigma = torch.sqrt(torch.clamp(torch.movedim(posterior.variance, mcmc_axis, 0), min=1e-12))
    p = torch.as_tensor(q_level, dtype=mu.dtype, device=mu.device)
    lo = torch.amin(mu - 6.0 * sigma, dim=0)
    hi = torch.amax(mu + 6.0 * sigma, dim=0)
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        below = torch.mean(ndtr((mid[None] - mu) / sigma), dim=0) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
