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
    """Add `jitter * max(mean(|diag(A)|), floor)` to the diagonal. `jitter`
    is a number or a tensor that broadcasts against `A.shape[:-2]`."""
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


def _all_finite(L: Tensor, batch_dims: int) -> Tensor:
    """Whether each element of the first `batch_dims` dims of `L` is finite
    throughout (every matrix and entry of it)."""
    return torch.isfinite(L.reshape(*L.shape[:batch_dims], -1)).all(-1)


def _per_element(jitter: Tensor, ndim: int) -> Tensor:
    """Per-element jitter `(*batch,)` shaped to broadcast against the
    `ndim - 2` leading dims of the matrices."""
    return jitter.reshape(tuple(jitter.shape) + (1,) * (ndim - 2 - jitter.ndim))


def _ladder(A: Tensor, base_jitter: float) -> Tensor:
    return torch.tensor(_JITTER_LADDER, dtype=A.dtype, device=A.device) + base_jitter


def jitter_rung(A: Tensor, base_jitter: float = DEFAULT_JITTER, batch_dims: int = 0) -> Tensor:
    """The jitter-ladder rung `psd_safe_cholesky` takes for each element of
    the first `batch_dims` dims of `A`, chosen without gradient: the first
    rung at which all of the element's matrices factor to finite values,
    else the top one. `(*A.shape[:batch_dims],)` int64."""
    if not 0 <= batch_dims <= A.ndim - 2:
        raise ValueError(f"batch_dims {batch_dims} out of range for shape {tuple(A.shape)}")
    ladder = _ladder(A, base_jitter)
    top = len(_JITTER_LADDER) - 1
    with torch.no_grad():
        A_sg = A.detach()
        if A.shape[-1] <= _LADDER_PROBE_MAX_N:
            probes = torch.stack([add_jitter(A_sg, j) for j in ladder.unbind()])
            oks = _all_finite(cholesky_nan(probes), batch_dims + 1)  # (rungs, *batch)
            # argmax gives the first successful rung
            return torch.where(oks.any(0), torch.argmax(oks.to(torch.int8), dim=0), top)
        # escalate only the elements that still fail, as a mapped
        # `while_loop` does
        idx = torch.zeros(A.shape[:batch_dims], dtype=torch.long, device=A.device)
        while True:
            L = cholesky(A_sg, jitter=_per_element(ladder[idx], A.ndim))
            bad = ~_all_finite(L, batch_dims) & (idx < top)
            if not bool(bad.any()):
                return idx
            idx = idx + bad.long()


def psd_safe_cholesky(
    A: Tensor, base_jitter: float = DEFAULT_JITTER, batch_dims: int = 0
) -> Tensor:
    """Cholesky with escalating-jitter rescue.

    The jitter rung is chosen without gradient for each element of the
    first `batch_dims` dims of `A` (`jitter_rung`: the t-batch, where the
    JAX package maps its unbatched function over candidate sets with
    `vmap`); then one differentiable factorization runs at each element's
    rung. With `batch_dims=0` the whole of `A` is one element."""
    idx = jitter_rung(A, base_jitter, batch_dims)
    return cholesky(A, jitter=_per_element(_ladder(A, base_jitter)[idx], A.ndim))


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
