r"""Hyperparameter priors: log-densities and sampling (counterpart of
`botorch_tpu/models/priors.py`).

MAP fitting adds `log_prob` of the constrained parameter value to the MLL,
with no change-of-variables Jacobian (gpytorch's `_add_other_terms`
semantics). `sample` draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

Tensor = torch.Tensor

_log_sqrt_2pi = 0.5 * math.log(2.0 * math.pi)


def _randn(generator, shape, dtype, device) -> Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _rand(generator, shape, dtype, device) -> Tensor:
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


@dataclass(frozen=True)
class LogNormal:
    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x: Tensor) -> Tensor:
        z = (torch.log(x) - self.loc) / self.scale
        return -0.5 * z * z - torch.log(x) - math.log(self.scale) - _log_sqrt_2pi

    def sample(self, generator, shape, dtype=torch.float32, device=None) -> Tensor:
        return torch.exp(self.loc + self.scale * _randn(generator, shape, dtype, device))

    @property
    def mode(self) -> float:
        return math.exp(self.loc - self.scale**2)


@dataclass(frozen=True)
class Gamma:
    concentration: float = 1.0
    rate: float = 1.0

    def log_prob(self, x: Tensor) -> Tensor:
        a, b = self.concentration, self.rate
        return a * math.log(b) - math.lgamma(a) + (a - 1.0) * torch.log(x) - b * x

    def sample(self, generator, shape, dtype=torch.float32, device=None) -> Tensor:
        """Marsaglia-Tsang rejection sampling (boosted for a < 1)."""
        a = self.concentration
        boost = a < 1.0
        a_eff = a + 1.0 if boost else a
        dd = a_eff - 1.0 / 3.0
        c = 1.0 / math.sqrt(9.0 * dd)
        out = torch.empty(shape, dtype=dtype, device=device)
        todo = torch.ones(shape, dtype=torch.bool, device=device)
        while bool(todo.any()):
            z = _randn(generator, shape, dtype, device)
            u = _rand(generator, shape, dtype, device)
            v = (1.0 + c * z) ** 3
            ok = (v > 0) & (
                torch.log(u) < 0.5 * z * z + dd - dd * v + dd * torch.log(v.clamp(min=1e-30))
            )
            take = todo & ok
            out = torch.where(take, dd * v, out)
            todo = todo & ~ok
        if boost:
            out = out * _rand(generator, shape, dtype, device) ** (1.0 / a)
        return out / self.rate

    @property
    def mode(self) -> float:
        a, b = self.concentration, self.rate
        return max((a - 1.0) / b, 1e-4) if a >= 1 else 1e-4


@dataclass(frozen=True)
class HalfCauchy:
    """Half-Cauchy on `x >= 0`: the SAAS shrinkage prior."""

    scale: float = 1.0

    def log_prob(self, x: Tensor) -> Tensor:
        return (
            math.log(2.0 / math.pi)
            - math.log(self.scale)
            - torch.log1p(torch.square(x / self.scale))
        )

    def sample(self, generator, shape, dtype=torch.float32, device=None) -> Tensor:
        u = 1e-7 + (1.0 - 2e-7) * _rand(generator, shape, dtype, device)
        return self.scale * torch.tan(0.5 * math.pi * u)

    @property
    def mode(self) -> float:
        return self.scale  # the median-scale init convention (the mode is 0)


@dataclass(frozen=True)
class Normal:
    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x: Tensor) -> Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - math.log(self.scale) - _log_sqrt_2pi

    def sample(self, generator, shape, dtype=torch.float32, device=None) -> Tensor:
        return self.loc + self.scale * _randn(generator, shape, dtype, device)

    @property
    def mode(self) -> float:
        return self.loc


def dim_scaled_lognormal_lengthscale_prior(d: int) -> LogNormal:
    """[Hvarfner2024vanilla] lengthscale prior: LogNormal(sqrt(2) + log(d)/2,
    sqrt(3))."""
    return LogNormal(loc=math.sqrt(2.0) + 0.5 * math.log(d), scale=math.sqrt(3.0))


def lognormal_noise_prior() -> LogNormal:
    """Noise prior LogNormal(-4, 1)."""
    return LogNormal(loc=-4.0, scale=1.0)


# Constraint floors.
MIN_INFERRED_NOISE_LEVEL = 1e-4
MIN_LENGTHSCALE = 2.5e-2


def gamma_lengthscale_prior() -> Gamma:
    """Legacy Matern lengthscale prior Gamma(3.0, 6.0)."""
    return Gamma(3.0, 6.0)


def gamma_noise_prior() -> Gamma:
    """Legacy likelihood noise prior Gamma(1.1, 0.05)."""
    return Gamma(1.1, 0.05)


def gamma_outputscale_prior() -> Gamma:
    """ScaleKernel outputscale prior Gamma(2.0, 0.15)."""
    return Gamma(2.0, 0.15)


def lengthscale_prior(priors: str, d: int):
    """The lengthscale prior for a named regime (`"lognormal"`/`"gamma"`)."""
    if priors == "gamma":
        return gamma_lengthscale_prior()
    return dim_scaled_lognormal_lengthscale_prior(d)


def noise_prior(priors: str):
    """The inferred-noise prior for a named regime."""
    if priors == "gamma":
        return gamma_noise_prior()
    return lognormal_noise_prior()
