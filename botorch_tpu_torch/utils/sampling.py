r"""Sampling utilities, the polytope part (counterpart of
`botorch_tpu/utils/sampling.py`): sphere and simplex draws, batched
multinomial, the Chebyshev centre of a polytope, hit-and-run and Delaunay
polytope samplers, and `get_polytope_samples` for linearly constrained
initial conditions.

The one-time geometry runs on the host, as in the JAX package: the
interior-point LP (scipy's HiGHS), the equality path's nullspace and the
Delaunay setup. The draws run on the device. Every random number comes
from a `torch.Generator`, or is passed in (`directions`, `uniforms`,
`simplex_index`) so that a test can replay another package's draws; a
sampler given neither raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from botorch_tpu_torch.sampling.sobol import draw_sobol, sobol_table

Tensor = torch.Tensor


def sample_hypersphere(
    generator: torch.Generator, d: int, n: int = 1, dtype=torch.float32
) -> Tensor:
    """`(n, d)` uniform points on the unit (d-1)-sphere."""
    z = torch.randn((n, d), generator=generator, dtype=dtype, device=generator.device)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def sample_simplex(
    generator: Optional[torch.Generator], d: int, n: int = 1, dtype=torch.float32,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """`(n, d)` uniform points on the probability simplex: the gaps between
    `d - 1` sorted uniforms (drawn, or `uniforms (n, d - 1)`)."""
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_simplex needs a generator or uniforms")
        uniforms = torch.rand((n, d - 1), generator=generator, dtype=dtype,
                              device=generator.device)
    u = torch.sort(uniforms, dim=-1).values
    zero = torch.zeros_like(u[:, :1])
    return torch.cat([u, zero + 1.0], dim=-1) - torch.cat([zero, u], dim=-1)


def batched_multinomial(
    generator: torch.Generator, weights: Tensor, num_samples: int
) -> Tensor:
    """Categorical draws without replacement from each row of `weights
    (..., k)`, by Gumbel-top-k: `(..., num_samples)` indices."""
    logits = torch.log(torch.clamp(weights, min=1e-30))
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype, device=logits.device)
    g = -torch.log(-torch.log(1e-20 + (1.0 - 1e-20) * u))
    return torch.topk(logits + g, num_samples, dim=-1).indices


def find_interior_point(
    A: np.ndarray, b: np.ndarray, bounds: Optional[np.ndarray] = None
) -> np.ndarray:
    """Chebyshev centre of `{x : A x <= b}` by an LP on the host (scipy's
    HiGHS): maximize `r` subject to `A x + |a_i| r <= b`."""
    from scipy.optimize import linprog

    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    d = A.shape[-1]
    norms = np.linalg.norm(A, axis=-1, keepdims=True)
    A_ub = np.concatenate([A, norms], axis=-1)
    c = np.zeros(d + 1)
    c[-1] = -1.0
    lp_bounds = [(None, None)] * d + [(0.0, None)]
    if bounds is not None:
        bounds = np.asarray(bounds, np.float64)
        lp_bounds[:d] = [(float(bounds[0, i]), float(bounds[1, i])) for i in range(d)]
    res = linprog(c, A_ub=A_ub, b_ub=b, bounds=lp_bounds, method="highs")
    if not res.success or res.x[-1] <= 1e-12:
        raise ValueError("polytope appears empty or degenerate")
    return res.x[:d]


def _draws(generator, directions, uniforms, steps: int, d: int, like: Tensor, who: str):
    if directions is None or uniforms is None:
        if generator is None:
            raise ValueError(f"{who} needs a generator or its draws (directions and uniforms)")
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)
        directions = torch.randn((steps, d), **kw)
        uniforms = torch.rand((steps,), **kw)
    if directions.shape != (steps, d) or uniforms.shape != (steps,):
        raise ValueError(f"{who}: expected draws of shape ({steps}, {d}) and ({steps},), got "
                         f"{tuple(directions.shape)} and {tuple(uniforms.shape)}")
    return directions.to(like), uniforms.to(like)


def sample_polytope(
    A: Tensor,
    b: Tensor,
    x0: Tensor,
    n: int = 1,
    n_burnin: int = 200,
    thinning: int = 32,
    generator: Optional[torch.Generator] = None,
    directions: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """`(n, d)` hit-and-run samples from `{x : A x <= b}`, from the interior
    point `x0`: each of `n_burnin + n * thinning` sequential steps picks a
    direction, finds the feasible chord along it from the slacks and steps
    to a uniform point of it, keeping every `thinning`-th state after the
    burn-in. A step whose point breaks a row by more than 1e-6 is rejected.

    Step i's draws are `directions[i] (d,)` (normal) and `uniforms[i]`,
    drawn from `generator` unless both are given. The chain stays on
    `x0`'s device; the directions' products with `A` are formed for all
    steps at once, and `A x` is carried from step to step."""
    d = x0.shape[-1]
    total = n_burnin + n * thinning
    A, b = A.to(x0), b.to(x0)
    directions, uniforms = _draws(generator, directions, uniforms, total, d, x0,
                                  "sample_polytope")
    U = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    AU = U @ A.T  # (total, k)
    inf = torch.tensor(torch.inf, dtype=x0.dtype, device=x0.device)
    t_scale = torch.where(torch.abs(AU) > 1e-12, AU, 1e-12)
    upper = AU > 1e-12
    lower = AU < -1e-12
    x, Ax = x0, A @ x0
    out = []
    for i in range(total):
        t = (b - Ax) / t_scale[i]
        hi = torch.amin(torch.where(upper[i], t, inf))
        lo = torch.amax(torch.where(lower[i], t, -inf))
        lam = lo + uniforms[i] * torch.clamp(hi - lo, min=0.0)
        x_new = x + lam * U[i]
        Ax_new = A @ x_new
        ok = torch.all(Ax_new <= b + 1e-6)
        x = torch.where(ok, x_new, x)
        Ax = torch.where(ok, Ax_new, Ax)
        if i >= n_burnin and (i - n_burnin) % thinning == 0:
            out.append(x)
    return torch.stack(out)


def sample_polytope_delaunay(
    A,
    b,
    n: int = 1,
    interior_point: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    simplex_index: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
    dtype=torch.float32,
    device=None,
) -> Tensor:
    """`(n, d)` exact i.i.d. uniform samples from the bounded polytope
    `{x : A x <= b}`: the vertices (halfspace intersection around an
    interior point), their Delaunay triangulation and the simplex volumes
    are set up once on the host with scipy; then each sample picks a
    simplex by volume and a uniform barycentric point in it. Vertex
    enumeration is exponential in the worst case: moderate `d` only.

    The draws are `simplex_index (n,)` and `uniforms (n, d)` (the sorted
    uniforms of `sample_simplex`; for `d = 1` the position on the segment),
    drawn from `generator` unless given; they live on `device` (the
    generator's if not given)."""
    from scipy.spatial import Delaunay, HalfspaceIntersection

    A_np = np.asarray(torch.as_tensor(A).cpu(), np.float64)
    b_np = np.asarray(torch.as_tensor(b).cpu(), np.float64).reshape(-1)
    d = A_np.shape[-1]
    if generator is None and (uniforms is None or (simplex_index is None and d > 1)):
        raise ValueError("sample_polytope_delaunay needs a generator or its draws")
    if device is None:
        device = generator.device if generator is not None else uniforms.device
    kw = dict(dtype=dtype, device=device)
    if uniforms is None:
        uniforms = torch.rand((n, d), generator=generator, **kw)
    uniforms = uniforms.to(**kw)
    x0 = (np.asarray(interior_point, np.float64).reshape(-1) if interior_point is not None
          else find_interior_point(A_np, b_np))
    if d == 1:
        # a segment; qhull needs d >= 2
        t = b_np / A_np[:, 0]
        hi = np.min(t[A_np[:, 0] > 0])
        lo = np.max(t[A_np[:, 0] < 0])
        return lo + (hi - lo) * uniforms
    hs = HalfspaceIntersection(np.c_[A_np, -b_np], x0)
    verts = hs.intersections
    simplices = verts[Delaunay(verts).simplices]  # (S, d + 1, d)
    vols = np.abs(np.linalg.det(simplices[:, 1:, :] - simplices[:, :1, :]))
    if simplex_index is None:
        probs = torch.as_tensor(vols / vols.sum(), **kw)
        simplex_index = torch.multinomial(probs, n, replacement=True, generator=generator)
    w = sample_simplex(None, d + 1, uniforms=uniforms)  # (n, d + 1) barycentric
    chosen = torch.as_tensor(simplices, **kw)[simplex_index.to(device)]
    return torch.sum(w[..., None] * chosen, dim=1)


def get_polytope_samples(
    generator: Optional[torch.Generator],
    n: int,
    bounds: Tensor,
    inequality_constraints: Optional[list] = None,
    equality_constraints: Optional[list] = None,
    n_burnin: int = 200,
    directions: Optional[Tensor] = None,
    uniforms: Optional[Tensor] = None,
) -> Tensor:
    """`(n, d)` samples from the box `bounds (2, d)` cut by the inequality
    tuples `sum_i coef_i x[idx_i] >= rhs` and the equality tuples
    (`= rhs`), on `bounds`' device and in its dtype.

    Equalities are handled by nullspace reduction: hit-and-run runs in the
    `d - k` coordinates `z` of `x = x0 + N z`, and its draws
    (`directions (steps, d - k)`, `uniforms (steps,)`, `steps = n_burnin +
    32 n`) have that width. Without any constraint the samples are
    scrambled Sobol points, with the scramble seed drawn from `generator`."""
    bounds = torch.as_tensor(bounds)
    d = bounds.shape[-1]
    if not inequality_constraints and not equality_constraints:
        if generator is None:
            raise ValueError("get_polytope_samples needs a generator for its Sobol seed")
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
        sv, shift = sobol_table(d, scramble=True, seed=seed, device=bounds.device)
        return bounds[0] + (bounds[1] - bounds[0]) * draw_sobol(sv, shift, n, dtype=bounds.dtype)
    # A x <= b: the box, then each >= row flipped
    lo_np, hi_np = (np.asarray(v.cpu(), np.float64) for v in bounds)
    A_rows, b_rows = [], []
    eye = np.eye(d)
    for i in range(d):
        A_rows.append(-eye[i])
        b_rows.append(-lo_np[i])
        A_rows.append(eye[i])
        b_rows.append(hi_np[i])
    for idx, coef, rhs in inequality_constraints or ():
        row = np.zeros(d)
        np.add.at(row, np.asarray(idx), -np.asarray(coef, np.float64))
        A_rows.append(row)
        b_rows.append(-float(rhs))
    A = np.stack(A_rows)
    b = np.asarray(b_rows)
    to = lambda a: torch.as_tensor(a, dtype=bounds.dtype, device=bounds.device)  # noqa: E731
    if equality_constraints:
        from botorch_tpu_torch.optim.constraints import AffineSubspace

        aff = AffineSubspace.build(equality_constraints, d, dtype=bounds.dtype,
                                   device=bounds.device)
        N = np.asarray(aff.basis.cpu(), np.float64)  # (d, d - k)
        x0e = np.asarray(aff.x0.cpu(), np.float64)
        # substitute x = x0e + N z:  (A N) z <= b - A x0e
        A_z = A @ N
        b_z = b - A @ x0e
        z = sample_polytope(to(A_z), to(b_z), to(find_interior_point(A_z, b_z)), n=n,
                            n_burnin=n_burnin, generator=generator, directions=directions,
                            uniforms=uniforms)
        return to(x0e) + z @ to(N.T)
    return sample_polytope(to(A), to(b), to(find_interior_point(A, b)), n=n, n_burnin=n_burnin,
                           generator=generator, directions=directions, uniforms=uniforms)
