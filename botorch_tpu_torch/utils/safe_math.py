r"""Numerically safe log-space math (counterpart of
`botorch_tpu/utils/safe_math.py`).

Smooth, fat-tailed approximations to `max`, ReLU and Heaviside whose
logarithms decay polynomially, so that gradients of the LogEI family
propagate far from the incumbent. Every function is elementwise or a
reduction, with each branch's input guarded by `torch.where` so that the
branch not taken cannot put a NaN into the gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

Tensor = torch.Tensor

_log2 = math.log(2.0)
_inv_sqrt_3 = math.sqrt(1.0 / 3.0)

TAU = 1.0  # default temperature for smooth non-linearities
ALPHA = 2.0  # default asymptotic power-decay exponent of `_pareto`

Dim = Union[int, Sequence[int]]


def _like(x: Tensor, value: float) -> Tensor:
    return torch.full_like(x, value)


def maximum(x: Tensor, value: float) -> Tensor:
    """`max(x, value)` with the gradient of `jnp.maximum`: split evenly
    between the two arguments at a tie (`torch.clamp` would pass all of it
    to `x`)."""
    return torch.maximum(x, x.new_full((), value))


def minimum(x: Tensor, value: float) -> Tensor:
    """`min(x, value)` with the gradient of `jnp.minimum` at ties."""
    return torch.minimum(x, x.new_full((), value))


def log1mexp(x: Tensor) -> Tensor:
    """Accurate `log(1 - exp(x))` for `x < 0` [Maechler2012accurate]."""
    is_small = x > -_log2
    x_small = torch.where(is_small, x, _like(x, -_log2))
    x_large = torch.where(is_small, _like(x, -_log2), x)
    return torch.where(
        is_small,
        torch.log(-torch.expm1(x_small)),
        torch.log1p(-torch.exp(x_large)),
    )


def log1pexp(x: Tensor) -> Tensor:
    """Accurate `log(1 + exp(x))` (softplus) [Maechler2012accurate]."""
    mask = x <= 18.0
    x_small = torch.where(mask, x, torch.zeros_like(x))
    x_large = torch.where(mask, torch.zeros_like(x), x)
    return torch.where(
        mask, torch.log1p(torch.exp(x_small)), x_large + torch.exp(-x_large)
    )


def logexpit(x: Tensor) -> Tensor:
    """`log(sigmoid(x))`."""
    return -log1pexp(-x)


def logplusexp(a: Tensor, b: Tensor) -> Tensor:
    """`log(exp(a) + exp(b))`, elementwise."""
    a, b = torch.broadcast_tensors(a, b)
    return logsumexp(torch.stack([a, b], dim=-1), dim=-1)


def logdiffexp(log_a: Tensor, log_b: Tensor) -> Tensor:
    """`log(b - a)` given `log_a <= log_b`."""
    log_a, log_b = torch.broadcast_tensors(log_a, log_b)
    is_inf = log_b == -math.inf
    safe_log_b = torch.where(is_inf, torch.zeros_like(log_b), log_b)
    return log_b + log1mexp(minimum(log_a - safe_log_b, 0.0))


def _normalize_dim(x: Tensor, dim: Dim) -> tuple[int, ...]:
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(a % x.ndim for a in dim)


def _inf_max_helper(max_fun, x: Tensor, dim: Dim, keepdim: bool) -> Tensor:
    """Inf-aware smooth max: +inf elements dominate exactly (gradient 1);
    all-(-inf) slices return -inf without NaN gradients."""
    dims = _normalize_dim(x, dim)
    m = torch.amax(x, dim=dims, keepdim=True)
    is_inf_max = torch.isinf(m) & (x == m)
    has_inf_max = torch.any(is_inf_max, dim=dims, keepdim=True)
    zeros = torch.zeros_like(x)
    y_inf = torch.where(is_inf_max, x, zeros)
    m_no_inf = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    y_no_inf = torch.where(has_inf_max, zeros, x) - m_no_inf
    res = torch.where(
        has_inf_max,
        torch.sum(y_inf, dim=dims, keepdim=True),
        m_no_inf + max_fun(y_no_inf, dims, True),
    )
    if keepdim:
        return res
    return res.squeeze(dims)


def logsumexp(x: Tensor, dim: Dim = -1, keepdim: bool = False) -> Tensor:
    """Inf-robust `logsumexp` (gradient 1 at +inf; finite on all-(-inf))."""

    def _lse(y, dims, kd):
        return torch.log(torch.sum(torch.exp(y), dim=dims, keepdim=kd))

    return _inf_max_helper(_lse, x=x, dim=dim, keepdim=keepdim)


def logmeanexp(x: Tensor, dim: Dim = -1, keepdim: bool = False) -> Tensor:
    """`log(mean(exp(x), dim))`, inf-robust."""
    dims = _normalize_dim(x, dim)
    n = math.prod(x.shape[a] for a in dims)
    return logsumexp(x, dim=dims, keepdim=keepdim) - math.log(n)


def smooth_amax(
    x: Tensor, dim: Dim = -1, keepdim: bool = False, tau: float = 1.0
) -> Tensor:
    """`tau * logsumexp(x / tau, dim)`: smooth max, tighter as tau -> 0."""
    return logsumexp(x / tau, dim=dim, keepdim=keepdim) * tau


def smooth_amin(
    x: Tensor, dim: Dim = -1, keepdim: bool = False, tau: float = 1.0
) -> Tensor:
    """Smooth approximation to `min(x, dim)`."""
    return -smooth_amax(-x, dim=dim, keepdim=keepdim, tau=tau)


def log_softplus(x: Tensor, tau: float = TAU) -> Tensor:
    """Accurate `log(softplus(x / tau) * tau)`."""
    z = x / tau
    lower = -15.0 if x.dtype == torch.float32 else -35.0
    mask = z > lower
    z_safe = torch.where(mask, z, _like(z, lower))
    return torch.where(
        mask, torch.log(log1pexp(z_safe)) + math.log(tau), z + math.log(tau)
    )


def cauchy(x: Tensor) -> Tensor:
    """Lorentzian (unnormalized Cauchy density): `1 / (1 + x^2)`."""
    return 1.0 / (1.0 + torch.square(x))


def fatplus(x: Tensor, tau: float = TAU) -> Tensor:
    """Fat-tailed smooth ReLU: `tau * (softplus(x/tau) + 0.1 * cauchy(x/tau))`."""
    alpha = 1e-1
    z = x / tau
    return tau * (log1pexp(z) + alpha * cauchy(z))


def log_fatplus(x: Tensor, tau: float = TAU) -> Tensor:
    """`log(fatplus(x, tau))`."""
    return torch.log(fatplus(x, tau=tau))


def _pareto(x: Tensor, alpha: float = ALPHA) -> Tensor:
    """Monotone rational decay: 1 at 0, unit first and second derivatives,
    `O(x^-alpha)`. `x` must be non-negative."""
    half = alpha / 2.0
    beta_1 = 2.0 * half
    beta_0 = half * beta_1
    return torch.pow(beta_0 / (beta_0 + beta_1 * x + torch.square(x)), half)


def fatmax(
    x: Tensor,
    dim: Dim = -1,
    keepdim: bool = False,
    tau: float = TAU,
    alpha: float = ALPHA,
) -> Tensor:
    """Fat-tailed smooth `amax(x, dim)` with `O(1/x^alpha)` tails."""

    def max_fun(y, dims, kd):
        return tau * torch.log(
            torch.sum(_pareto(-y / tau, alpha=alpha), dim=dims, keepdim=kd)
        )

    return _inf_max_helper(max_fun=max_fun, x=x, dim=dim, keepdim=keepdim)


def fatmin(
    x: Tensor,
    dim: Dim = -1,
    keepdim: bool = False,
    tau: float = TAU,
    alpha: float = ALPHA,
) -> Tensor:
    """Fat-tailed smooth `amin(x, dim)`."""
    return -fatmax(-x, dim=dim, keepdim=keepdim, tau=tau, alpha=alpha)


def fatmaximum(a: Tensor, b: Tensor, tau: float = TAU, alpha: float = ALPHA) -> Tensor:
    """Fat-tailed smooth elementwise `maximum(a, b)`."""
    a, b = torch.broadcast_tensors(a, b)
    return fatmax(torch.stack([a, b], dim=-1), dim=-1, tau=tau, alpha=alpha)


def fatminimum(a: Tensor, b: Tensor, tau: float = TAU, alpha: float = ALPHA) -> Tensor:
    """Fat-tailed smooth elementwise `minimum(a, b)`."""
    return -fatmaximum(-a, -b, tau=tau, alpha=alpha)


def fatmoid(x: Tensor, tau: float = 1.0) -> Tensor:
    """Twice-differentiable fat-tailed Heaviside approximation with
    `O(1/x^2)` tails on both sides."""
    z = x / tau
    m = _inv_sqrt_3
    return torch.where(
        z < 0,
        2.0 / 3.0 * cauchy(z - m),
        1.0 - 2.0 / 3.0 * cauchy(z + m),
    )


def log_fatmoid(x: Tensor, tau: float = 1.0) -> Tensor:
    """`log(fatmoid(x, tau))`."""
    return torch.log(fatmoid(x, tau=tau))


def sigmoid(x: Tensor, log: bool = False, fat: bool = False) -> Tensor:
    """(Log-)sigmoid with optional fat tail."""
    y = log_fatmoid(x) if fat else logexpit(x)
    return y if log else torch.exp(y)
