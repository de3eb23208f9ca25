r"""PSD-safe Cholesky factorization and triangular solves (counterpart of
`botorch_tpu/ops/chol.py`).

The same float32 jitter policy as the reference: a small relative jitter
is always added before a factorization, and `psd_safe_cholesky` escalates
along a fixed ladder when a factorization fails. A failed factorization
yields NaN, as JAX's does, instead of raising (`torch.linalg.cholesky_ex`
with the failed batch entries set to NaN).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Relative jitter always added before factorization (float32 regime).
DEFAULT_JITTER = 1e-6
# Escalation ladder for `psd_safe_cholesky` (relative to mean |diagonal|).
_JITTER_LADDER = (0.0, 1e-6, 1e-4, 1e-2, 1e-1, 1.0, 1e2)
# Absolute floor on the jitter scale.
_SCALE_FLOOR = 1e-10
# Up to this size every ladder rung is probed at once; above it the probe
# escalates one rung at a time (`botorch_tpu/ops/chol.py:47-95`).
_LADDER_PROBE_MAX_N = 256


def add_jitter(A: Tensor, jitter=DEFAULT_JITTER) -> Tensor:
    """Add `jitter * max(mean(|diag(A)|), floor)` to the diagonal."""
    n = A.shape[-1]
    diag_mean = torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    scale = torch.clamp(diag_mean, min=_SCALE_FLOOR)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return A + (jitter * scale)[..., None, None] * eye


def cholesky_nan(A: Tensor) -> Tensor:
    """Lower Cholesky factor of `A`, NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def cholesky(A: Tensor, jitter=DEFAULT_JITTER) -> Tensor:
    """Lower Cholesky factor of `A + jitter * mean(diag) * I` (differentiable)."""
    return cholesky_nan(add_jitter(A, jitter))


def psd_safe_cholesky(A: Tensor, base_jitter: float = DEFAULT_JITTER) -> Tensor:
    """Cholesky with escalating-jitter rescue.

    The jitter level is chosen without gradient, then one differentiable
    factorization runs at that level. A rung succeeds when every matrix of
    the batch factors to finite values."""
    ladder = torch.tensor(_JITTER_LADDER, dtype=A.dtype) + base_jitter
    top = len(_JITTER_LADDER) - 1
    with torch.no_grad():
        A_sg = A.detach()
        if A.shape[-1] <= _LADDER_PROBE_MAX_N:
            probes = torch.stack([add_jitter(A_sg, j) for j in ladder.tolist()])
            L, info = torch.linalg.cholesky_ex(probes)
            lead = (len(_JITTER_LADDER), -1)
            oks = (info.reshape(lead) == 0).all(-1) & torch.isfinite(L.reshape(lead)).all(-1)
            ok_list = oks.tolist()
            idx = ok_list.index(True) if any(ok_list) else top
        else:
            idx = 0
            while idx < top:
                L = cholesky(A_sg, jitter=ladder[idx].item())
                if bool(torch.isfinite(L).all()):
                    break
                idx += 1
    return cholesky(A, jitter=ladder[idx].item())


def solve_triangular(L: Tensor, b: Tensor, lower: bool = True, trans: bool = False) -> Tensor:
    """Batched triangular solve `L x = b` (or `L^T x = b` if `trans`)."""
    A = L.transpose(-1, -2) if trans else L
    return torch.linalg.solve_triangular(A, b, upper=(lower == trans))


def cholesky_solve(L: Tensor, b: Tensor) -> Tensor:
    """Solve `A x = b` given the lower Cholesky factor `L` of `A`."""
    y = solve_triangular(L, b, lower=True)
    return solve_triangular(L, y, lower=True, trans=True)


def chol_logdet(L: Tensor) -> Tensor:
    """`log det(A)` from the lower Cholesky factor of `A`."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
