r"""Parameter constraints for acquisition optimization (counterpart of
`botorch_tpu/optim/constraints.py`).

A linear constraint is a tuple `(indices, coefficients, rhs)`:
`sum_i coef_i x[idx_i] >= rhs` (an inequality) or `= rhs` (an equality).
1-d indices apply to every candidate of the q-batch (intra-point); 2-d
indices `((q_i, d_i), ...)` make one row over the whole q-batch
(inter-point). A nonlinear constraint is `g` or `(g, intra_point)` with
`g >= 0` feasible; an intra-point `g` maps points `(..., d) -> (...)`, an
inter-point one q-batches `(..., q, d) -> (...)`.

* Equalities: `AffineSubspace` holds the exact projector onto
  `{A x = b}`, factored once on the host in float64 (rank test, pivoted QR
  of redundant rows, pseudo-inverse, nullspace SVD) and then moved to the
  device.
* `project_box_affine_halfspaces` polishes candidates by Dykstra's
  alternating projections onto `box ∩ affine ∩ halfspaces`.
* `make_al_objective` builds the augmented Lagrangian that
  `optimize_acqf` minimizes over restart lanes, each with its own
  multipliers.

Every contraction runs in full float32 on the card (TF32 is off, see
`settings.apply_precision_policy`): a 1e-3 TF32 error in `A x` would break
`FEASIBILITY_TOL`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from botorch_tpu_torch.settings import resolve_device
from botorch_tpu_torch.utils import safe_math as sm

Tensor = torch.Tensor

#: returned candidates violate their linear constraints by no more than this
#: (float32 alternating-projection accuracy)
FEASIBILITY_TOL = 1e-5


def _dense_rows(constraints: Sequence, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Intra-point constraint tuples -> dense `(A (k, d), rhs (k,))`.
    Coefficients of repeated indices add up (`((0, 0), (1, 1), 1)` is
    `2 x0 >= 1`)."""
    A = np.zeros((len(constraints), d))
    b = np.zeros((len(constraints),))
    for i, (idx, coef, rhs) in enumerate(constraints):
        idx_np = np.asarray(idx)
        if idx_np.ndim == 2:
            raise ValueError(
                "intra-point constraints only: got 2-d (inter-point) indices; use the "
                "joint-q form (_dense_rows_flat) instead"
            )
        np.add.at(A[i], idx_np, np.asarray(coef, np.float64))
        b[i] = float(rhs)
    return A, b


def is_interpoint(constraints: Optional[Sequence]) -> bool:
    """True if any tuple has 2-d indices `((q_i, d_i), ...)`."""
    return any(np.asarray(idx).ndim == 2 for idx, _, _ in constraints or ())


def _dense_rows_flat(constraints: Sequence, q: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Constraint tuples -> dense rows over the flattened `(q * d,)` q-batch:
    an intra-point tuple gives `q` rows (one per candidate), an inter-point
    tuple one joint row. Coefficients of repeated indices add up."""
    rows, rhs = [], []
    for idx, coef, r in constraints:
        idx_np = np.asarray(idx)
        coef_np = np.asarray(coef, np.float64)
        if idx_np.ndim == 2:
            row = np.zeros(q * d)
            np.add.at(row, idx_np[:, 0] * d + idx_np[:, 1], coef_np)
            rows.append(row)
            rhs.append(float(r))
        else:
            for j in range(q):
                row = np.zeros(q * d)
                np.add.at(row, j * d + idx_np, coef_np)
                rows.append(row)
                rhs.append(float(r))
    if not rows:
        return np.zeros((0, q * d)), np.zeros((0,))
    return np.stack(rows), np.asarray(rhs)


def _device_dtype(device, dtype) -> tuple[torch.device, torch.dtype]:
    return resolve_device(device), (torch.float64 if dtype == torch.float64 else torch.float32)


@dataclass(frozen=True)
class AffineSubspace:
    """Geometry of `{x : A x = b}` for `d` variables, on the device.

    `project(x) = x - pinv (A x - b)` is the exact Euclidean projection;
    `basis` spans the nullspace, so `x = x0 + basis @ z` parameterizes the
    subspace."""

    A: Tensor  # (k, d)
    b: Tensor  # (k,)
    pinv: Tensor  # (d, k) = A^T (A A^T)^-1
    basis: Tensor  # (d, d - k) orthonormal nullspace basis
    x0: Tensor  # (d,) least-norm solution

    @staticmethod
    def build(equality_constraints: Sequence, d: int, dtype=None, device=None) -> "AffineSubspace":
        return AffineSubspace.from_dense(*_dense_rows(equality_constraints, d), dtype=dtype,
                                         device=device)

    @staticmethod
    def from_dense(A, b, dtype=None, device=None) -> "AffineSubspace":
        """Factor on the host in float64, then move to `device` (CUDA unless
        given) in float32, or float64 if `dtype` is float64. Consistent
        redundant rows are reduced to an independent subset (QR with column
        pivoting on `A^T`); an inconsistent system raises."""
        device, dtype = _device_dtype(device, dtype)
        A = np.asarray(A, np.float64)
        b = np.asarray(b, np.float64)
        rank = np.linalg.matrix_rank(A)
        if rank < A.shape[0]:
            aug_rank = np.linalg.matrix_rank(np.concatenate([A, b[:, None]], axis=1))
            if aug_rank > rank:
                raise ValueError(
                    "equality_constraints are inconsistent (no feasible point satisfies "
                    "all of them)"
                )
            from scipy.linalg import qr

            _, _, piv = qr(A.T, pivoting=True)
            keep = np.sort(piv[:rank])
            A, b = A[keep], b[keep]
        pinv = A.T @ np.linalg.inv(A @ A.T)
        _, _, Vt = np.linalg.svd(A, full_matrices=True)
        basis = Vt[A.shape[0]:].T  # (d, d - k), orthonormal
        x0 = pinv @ b
        to = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
        return AffineSubspace(A=to(A), b=to(b), pinv=to(pinv), basis=to(basis), x0=to(x0))

    def _residual(self, x: Tensor) -> Tensor:
        return x @ self.A.T - self.b

    def project(self, x: Tensor) -> Tensor:
        """Euclidean projection of `(..., d)` onto the subspace."""
        return x - self._residual(x) @ self.pinv.T

    def violation(self, x: Tensor) -> Tensor:
        """`max |A x - b|` over the rows, per `(..., d)` point."""
        return torch.amax(torch.abs(self._residual(x)), dim=-1)


def project_box_affine_halfspaces(
    x: Tensor,
    lo: Tensor,
    hi: Tensor,
    affine: Optional[AffineSubspace] = None,
    A_ineq: Optional[Tensor] = None,
    b_ineq: Optional[Tensor] = None,
    iters: int = 60,
) -> Tensor:
    """Dykstra's alternating projections of `x (..., d)` onto
    `[lo, hi] ∩ {A_eq x = b_eq} ∩ {A_ineq x >= b_ineq}`.

    Box and affine set are exact projections; the halfspace operator is one
    cyclic sweep over the rows in order (the result depends on that order),
    so with `A_ineq` the result is a convergent feasibility polish rather
    than the exact projection. After `iters` rounds an exact affine
    projection and a clip leave the equality residual at roundoff."""
    sets: list[Callable[[Tensor], Tensor]] = [lambda v: torch.clamp(v, lo, hi)]
    if affine is not None:
        sets.append(affine.project)
    if A_ineq is not None and A_ineq.shape[0] > 0:
        nrm2 = torch.sum(A_ineq * A_ineq, dim=-1)

        def proj_half(v: Tensor) -> Tensor:
            for i in range(A_ineq.shape[0]):
                a = A_ineq[i]
                gap = sm.minimum(v @ a - b_ineq[i], 0.0)
                v = v - (gap / nrm2[i])[..., None] * a
            return v

        sets.append(proj_half)

    corr = [torch.zeros_like(x) for _ in sets]
    for _ in range(iters):
        for i, proj in enumerate(sets):
            y = proj(x + corr[i])
            corr[i] = x + corr[i] - y
            x = y
    if affine is not None:
        x = torch.clamp(affine.project(x), lo, hi)
    return x


def _flat_rows(constraints, q: int, d: int, like: Tensor) -> tuple[Tensor, Tensor]:
    A, b = _dense_rows_flat(constraints, q, d)
    return (torch.as_tensor(A, dtype=like.dtype, device=like.device),
            torch.as_tensor(b, dtype=like.dtype, device=like.device))


def linear_violation(
    Xq: Tensor,
    inequality_constraints: Optional[Sequence] = None,
    equality_constraints: Optional[Sequence] = None,
) -> Tensor:
    """Max violation of the constraint tuples over `(..., q, d)` candidates
    (0 where feasible), intra- and inter-point alike."""
    q, d = Xq.shape[-2:]
    v = Xq.reshape(*Xq.shape[:-2], q * d)
    total = torch.zeros(Xq.shape[:-2], dtype=Xq.dtype, device=Xq.device)
    if inequality_constraints:
        A, b = _flat_rows(inequality_constraints, q, d, v)
        total = torch.maximum(total, torch.amax(sm.maximum(b - v @ A.T, 0.0), dim=-1))
    if equality_constraints:
        A, b = _flat_rows(equality_constraints, q, d, v)
        total = torch.maximum(total, torch.amax(torch.abs(v @ A.T - b), dim=-1))
    return total


def _unpack(con) -> tuple[Callable, bool]:
    return con if isinstance(con, tuple) else (con, True)


def nonlinear_values(Xq: Tensor, nonlinear_inequality_constraints: Sequence) -> Tensor:
    """The values `g >= 0` of the nonlinear constraints at `(..., q, d)`
    candidates -> `(..., n_vals)`: `q` values for each intra-point `g`,
    one for each inter-point `g`, in the constraints' order."""
    vals = []
    for con in nonlinear_inequality_constraints:
        g, intra = _unpack(con)
        vals.append(g(Xq) if intra else g(Xq)[..., None])
    return torch.cat(vals, dim=-1)


def max_violation(
    Xq: Tensor,
    inequality_constraints: Optional[Sequence] = None,
    equality_constraints: Optional[Sequence] = None,
    nonlinear_inequality_constraints: Optional[Sequence] = None,
) -> Tensor:
    """Max violation of the linear tuples and the nonlinear `g >= 0` over
    `(..., q, d)` candidates (0 where feasible): what `optimize_acqf` holds
    to `FEASIBILITY_TOL`."""
    viol = linear_violation(Xq, inequality_constraints, equality_constraints)
    if nonlinear_inequality_constraints:
        nl = nonlinear_values(Xq, nonlinear_inequality_constraints)
        viol = torch.maximum(viol, torch.amax(torch.clamp(-nl, min=0.0), dim=-1))
    return viol


def make_al_objective(
    neg_fun: Callable[[Tensor], Tensor],
    q: int,
    d: int,
    inequality_constraints: Optional[Sequence] = None,
    equality_constraints: Optional[Sequence] = None,
    nonlinear_inequality_constraints: Optional[Sequence] = None,
    dtype=None,
    device=None,
):
    """The augmented-Lagrangian pieces for `min neg_fun(v)` subject to the
    constraints, over flattened lanes `V (r, q * d)`.

    Returns `(al_obj, n_eq, n_ineq, constraint_vals)`:
    `al_obj(V, lam (r, n_eq), mu (r, n_ineq), rho) -> (r,)` is the AL
    objective of each lane with its own multipliers (lanes never mix), and
    `constraint_vals(V) -> (h (r, n_eq), c (r, n_ineq))` gives the equality
    residuals (want 0) and the inequality values (want >= 0). The
    inequality term is Rockafellar's form for `c >= 0`, `mu >= 0`."""
    device, dtype = _device_dtype(device, dtype)
    nl = list(nonlinear_inequality_constraints or ())
    A_eq_np, b_eq_np = _dense_rows_flat(list(equality_constraints or ()), q, d)
    A_in_np, b_in_np = _dense_rows_flat(list(inequality_constraints or ()), q, d)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    A_eq, b_eq, A_in, b_in = to(A_eq_np), to(b_eq_np), to(A_in_np), to(b_in_np)
    n_eq = A_eq_np.shape[0]
    n_ineq = A_in_np.shape[0] + sum(q if _unpack(con)[1] else 1 for con in nl)

    def constraint_vals(V: Tensor) -> tuple[Tensor, Tensor]:
        h = V @ A_eq.T - b_eq
        c = V @ A_in.T - b_in
        if nl:
            c = torch.cat([c, nonlinear_values(V.reshape(*V.shape[:-1], q, d), nl)], dim=-1)
        return h, c

    def al_obj(V: Tensor, lam: Tensor, mu: Tensor, rho) -> Tensor:
        h, c = constraint_vals(V)
        obj = neg_fun(V)
        if n_eq:
            obj = obj + torch.sum(lam * h, dim=-1) + 0.5 * rho * torch.sum(h * h, dim=-1)
        if n_ineq:
            t = sm.maximum(mu - rho * c, 0.0)
            obj = obj + torch.sum(t * t - mu * mu, dim=-1) / (2.0 * rho)
        return obj

    return al_obj, n_eq, n_ineq, constraint_vals
