r"""Stable standard-normal special functions (counterpart of
`botorch_tpu/utils/probability.py`).

The formulas are the JAX package's, so that both packages agree to
rounding: `erfcx` is `exp(x^2) erfc(x)` for `x <= 6` and an 8-term
asymptotic series beyond, and the LogEI helper switches branches at
`u = -1` exactly as the reference does. Every function is elementwise
with `torch.where`-guarded branch inputs, so gradients stay finite.
"""

from __future__ import annotations

import math

import torch

from botorch_tpu_torch.utils.safe_math import log1mexp, maximum, minimum

Tensor = torch.Tensor

_inv_sqrt_2 = math.sqrt(0.5)
_neg_inv_sqrt_2 = -_inv_sqrt_2
_inv_sqrt_2pi = 1.0 / math.sqrt(2.0 * math.pi)
_log_sqrt_2pi = math.log(2.0 * math.pi) / 2.0
_log_2 = math.log(2.0)
_log_sqrt_pi_div_2 = math.log(math.pi / 2.0) / 2.0
_sqrt_pi = math.sqrt(math.pi)


def ndtr(x: Tensor) -> Tensor:
    """Standard normal CDF `Phi(x)`."""
    return 0.5 * torch.special.erfc(_neg_inv_sqrt_2 * x)


def phi(x: Tensor) -> Tensor:
    """Standard normal PDF."""
    return _inv_sqrt_2pi * torch.exp(-0.5 * torch.square(x))


def log_phi(x: Tensor) -> Tensor:
    """Log of the standard normal PDF."""
    return -0.5 * torch.square(x) - _log_sqrt_2pi


def erfcx(x: Tensor) -> Tensor:
    """Scaled complementary error function `exp(x^2) * erfc(x)`: direct for
    `x <= 6`, the 8-term asymptotic series beyond."""
    direct_ok = x <= 6.0
    x_direct = torch.where(direct_ok, x, 0.0)
    direct = torch.exp(torch.square(x_direct)) * torch.special.erfc(x_direct)

    x_tail = torch.where(direct_ok, 6.0, x)
    z = 0.5 / torch.square(x_tail)  # series variable: (2x^2)^-1
    series = 1.0 + z * (-1.0 + z * (3.0 + z * (-15.0 + z * (105.0 + z * (
        -945.0 + z * (10395.0 - z * 135135.0))))))
    tail = series / (x_tail * _sqrt_pi)
    return torch.where(direct_ok, direct, tail)


def log_erfc(x: Tensor) -> Tensor:
    """Stable `log(erfc(x))`."""
    is_pos = x > 0
    x_pos = torch.where(is_pos, x, 0.0)
    x_neg = torch.where(is_pos, 0.0, x)
    return torch.where(
        is_pos,
        torch.log(erfcx(x_pos)) - torch.square(x_pos),
        torch.log(torch.special.erfc(x_neg)),
    )


def log_erfcx(x: Tensor) -> Tensor:
    """Stable `log(erfcx(x))`."""
    is_pos = x > 0
    x_pos = torch.where(is_pos, x, 0.0)
    x_neg = torch.where(is_pos, 0.0, x)
    return torch.where(
        is_pos,
        torch.log(erfcx(x_pos)),
        torch.log(torch.special.erfc(x_neg)) + torch.square(x),
    )


def log_ndtr(x: Tensor) -> Tensor:
    """Stable `log(Phi(x))` with usable gradients for large negative `x`."""
    return log_erfc(_neg_inv_sqrt_2 * x) - _log_2


def standard_normal_log_hazard(x: Tensor) -> Tensor:
    """`log(phi(x) / Phi(-x))`, stable in both tails."""
    return math.log(2.0 * _inv_sqrt_2pi) - log_erfcx(_inv_sqrt_2 * x)


def log_prob_normal_in(a: Tensor, b: Tensor) -> Tensor:
    """`log(Phi(b) - Phi(a))` for `a < b`, stable over huge ranges: where
    `|b| > |a|`, `Phi(b) - Phi(a) = Phi(-a) - Phi(-b)` takes the difference
    in the well-behaved left tail of `log_ndtr`."""
    a, b = torch.broadcast_tensors(a, b)
    rev = torch.abs(b) > torch.abs(a)
    a2 = torch.where(rev, -b, a)
    b2 = torch.where(rev, -a, b)
    return log1mexp(minimum(log_ndtr(a2) - log_ndtr(b2), 0.0)) + log_ndtr(b2)


def ei_helper(u: Tensor) -> Tensor:
    """`phi(u) + u * Phi(u)`: EI in units of the posterior stddev."""
    return phi(u) + u * ndtr(u)


def _log_abs_u_Phi_div_phi(u: Tensor) -> Tensor:
    """`log(|u| * Phi(u) / phi(u))` for `u < 0`."""
    return torch.log(erfcx(_neg_inv_sqrt_2 * u) * torch.abs(u)) + _log_sqrt_pi_div_2


def log_ei_helper(u: Tensor) -> Tensor:
    """Stable `log(phi(u) + u * Phi(u))`, differentiable for u in
    [-1e20, 1e20] in float32 [Ament2023logei]."""
    bound = -1.0
    neg_inv_sqrt_eps = -1e6 if u.dtype == torch.float64 else -1e3

    # Branch 1 (u > -1): the naive formula in log space is accurate.
    u_upper = maximum(u, bound)
    log_ei_upper = torch.log(ei_helper(u_upper))

    # Branch 2 (u <= -1): log(phi(u)) + log(1 - exp(w)),
    #   w = log(|u| Phi(u) / phi(u)) < 0.
    u_lower = minimum(u, bound)
    u_eps = maximum(u_lower, neg_inv_sqrt_eps)
    w = minimum(_log_abs_u_Phi_div_phi(u_eps), -torch.finfo(u.dtype).tiny)
    log_ei_lower = log_phi(u) + torch.where(
        u > neg_inv_sqrt_eps,
        log1mexp(w),
        # Leading order of log1mexp(w) for extremely negative u.
        -2.0 * torch.log(torch.abs(u_lower)),
    )
    return torch.where(u > bound, log_ei_upper, log_ei_lower)
