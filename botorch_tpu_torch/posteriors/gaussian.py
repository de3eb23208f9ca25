r"""Gaussian posterior with reparameterized sampling (counterpart of
`botorch_tpu/posteriors/gaussian.py`).

Shapes follow BoTorch: `mean` is `batch x q x m`, `cov` is
`batch x m x q x q` (outputs independent, joint over q), base samples and
draws are `sample_shape x batch x q x m`. The batch dims are the t-batch
(candidate sets evaluated at once), where the JAX package maps an
unbatched posterior with `vmap`: each batch element is a posterior of its
own, and `scale_tril` picks the jitter of each element's factor apart.

`rsample_from_base_samples` is the Sample-Average-Approximation path:
draws are the deterministic, differentiable `mean + L @ eps` of fixed base
samples, which is what lets a gradient-based optimizer ascend an MC
acquisition value.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from botorch_tpu_torch.ops.chol import psd_safe_cholesky
from botorch_tpu_torch.utils.safe_math import maximum

Tensor = torch.Tensor


@dataclass(frozen=True)
class GaussianPosterior:
    """Joint Gaussian posterior over `q` points and `m` independent outputs."""

    mean: Tensor  # (..., q, m)
    cov: Tensor  # (..., m, q, q)

    @property
    def variance(self) -> Tensor:  # (..., q, m)
        v = torch.diagonal(self.cov, dim1=-2, dim2=-1)  # (..., m, q)
        return maximum(v.transpose(-1, -2), 0.0)

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.mean.shape[:-2])

    @property
    def q(self) -> int:
        return self.mean.shape[-2]

    @property
    def num_outputs(self) -> int:
        return self.mean.shape[-1]

    @property
    def scale_tril(self) -> Tensor:  # (..., m, q, q)
        """PSD-safe Cholesky factor of `cov`, its jitter rung chosen per
        batch element."""
        return psd_safe_cholesky(self.cov, batch_dims=len(self.batch_shape))

    @property
    def base_sample_shape(self) -> tuple[int, ...]:
        return (*self.batch_shape, self.q, self.num_outputs)

    def rsample_from_base_samples(self, base_samples: Tensor) -> Tensor:
        """Reparameterized draws `mean + L @ eps` from standard-normal
        `base_samples (sample_shape, ..., q, m)`, cast to the factor's
        dtype; differentiable in the posterior's parameters."""
        L = self.scale_tril  # (..., m, q, q)
        eps = base_samples.to(L.dtype).transpose(-1, -2)[..., None]  # (s, ..., m, q, 1)
        draw = torch.matmul(L, eps)[..., 0]  # (s, ..., m, q)
        return self.mean + draw.transpose(-1, -2)

    def rsample(self, generator: torch.Generator, sample_shape: tuple[int, ...] = ()) -> Tensor:
        """Reparameterized draws from fresh base samples of `generator`."""
        base = torch.randn(
            (*sample_shape, *self.base_sample_shape), generator=generator,
            dtype=self.mean.dtype, device=self.mean.device,
        )
        return self.rsample_from_base_samples(base)

    def quantile(self, value) -> Tensor:
        """Marginal per-point quantiles: the inverse CDF of each marginal
        `N(mean, var)` at probability `value`. A scalar `value` gives
        `(..., q, m)`; a vector of `k` probabilities a leading `k` dim."""
        value = torch.as_tensor(value, dtype=self.mean.dtype, device=self.mean.device)
        z = torch.special.ndtri(value)
        if value.ndim > 0:
            z = z.reshape((-1,) + (1,) * self.mean.ndim)
        return self.mean + z * torch.sqrt(self.variance)

    def density(self, value) -> Tensor:
        """Marginal probability density at `value`, pointwise. A scalar
        `value` broadcasts; a vector of `k` values gets a leading `k` dim."""
        value = torch.as_tensor(value, dtype=self.mean.dtype, device=self.mean.device)
        sd = torch.sqrt(maximum(self.variance, 1e-30))
        if value.ndim > 0:
            value = value.reshape((-1,) + (1,) * self.mean.ndim)
        u = (value - self.mean) / sd
        return torch.exp(-0.5 * u * u) / (sd * math.sqrt(2.0 * math.pi))

    def affine(self, loc: Tensor, scale: Tensor) -> "GaussianPosterior":
        """Per-output affine map `y -> loc + scale * y` (outcome
        de-standardization)."""
        mean = self.mean * scale + loc
        cov = self.cov * torch.square(torch.atleast_1d(scale))[..., :, None, None]
        return GaussianPosterior(mean=mean, cov=cov)


def scalarize_posterior(
    post: GaussianPosterior, weights, offset: float = 0.0
) -> GaussianPosterior:
    """Affine scalarization `w . f(x) + offset` of a multi-output posterior
    into a single-output one. Outputs are independent in this layout, so
    the scalarized covariance is `sum_m w_m^2 Sigma_m`."""
    w = torch.as_tensor(weights, dtype=post.mean.dtype, device=post.mean.device)
    mean = torch.sum(post.mean * w, dim=-1, keepdim=True) + offset
    cov = torch.sum(post.cov * torch.square(w)[..., :, None, None], dim=-3, keepdim=True)
    return GaussianPosterior(mean=mean, cov=cov)
