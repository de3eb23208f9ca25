r"""Batched bound-constrained L-BFGS (counterpart of `botorch_tpu/ops/lbfgs.py`).

Restarts sit on a leading lane dim `r`: the objective is batched,
`fun(X: (r, k)) -> (r,)`, with lanes independent of each other, and the
gradient of each lane comes from one backward pass of `fun(X).sum()`.
Every lane runs the reference's algorithm on its own: a fixed-size
two-loop history ring, a projected Armijo backtracking line search for the
box, and a convergence mask that freezes a finished lane exactly as the
JAX `while_loop` under `vmap` does. The loops end when no lane is active.

Line-search modes, as in the reference: "halving" (acquisition surfaces)
and "interp" (quadratic interpolation with step memory, for model fits).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


class LBFGSState(NamedTuple):
    x: Tensor  # (r, k) current iterate
    f: Tensor  # (r,) current value
    g: Tensor  # (r, k) current gradient
    S: Tensor  # (r, m, k) s-history ring
    Y: Tensor  # (r, m, k) y-history ring
    rho: Tensor  # (r, m) 1/(s.y) history ring (0 = invalid slot)
    head: Tensor  # (r,) next ring slot to write
    n_iter: Tensor  # (r,)
    n_fev: Tensor  # (r,) objective evaluations (incl. line-search trials)
    t_prev: Tensor  # (r,) last accepted line-search step
    stall: Tensor  # (r,) consecutive iterations without material descent
    converged: Tensor  # (r,) bool
    failed: Tensor  # (r,) bool (line search failed to make progress)


class LBFGSResult(NamedTuple):
    x: Tensor
    fun: Tensor
    grad: Tensor
    n_iter: Tensor
    n_fev: Tensor
    converged: Tensor


def value_and_grad(fun: Callable[[Tensor], Tensor], x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-lane values and gradients of a batched objective."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = fun(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
    return f.detach(), g


def _value(fun: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    with torch.no_grad():
        return fun(x)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _two_loop(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, head: Tensor) -> Tensor:
    """Two-loop recursion for the search direction `-H g`, per lane.
    Invalid slots carry `rho = 0` and are no-ops."""
    r, m, _ = S.shape
    lanes = torch.arange(r, device=g.device)
    q = g
    alpha = torch.zeros((r, m), dtype=g.dtype, device=g.device)
    for i in range(m):
        slot = (head - 1 - i) % m
        a = rho[lanes, slot] * _dot(S[lanes, slot], q)
        q = q - a[:, None] * Y[lanes, slot]
        alpha[lanes, slot] = a

    newest = (head - 1) % m
    sy = _dot(S[lanes, newest], Y[lanes, newest])
    yy = _dot(Y[lanes, newest], Y[lanes, newest])
    gamma0 = 1.0 / torch.clamp(torch.linalg.vector_norm(g, dim=-1), min=1.0)
    gamma = torch.where(
        (rho[lanes, newest] > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-30), gamma0
    )
    v = gamma[:, None] * q
    for i in range(m):
        slot = (head + i) % m
        b = rho[lanes, slot] * _dot(Y[lanes, slot], v)
        v = v + S[lanes, slot] * (alpha[lanes, slot] - b)[:, None]
    return -v


def _resolve_bounds(bounds, k: int, like: Tensor) -> tuple[Tensor, Tensor]:
    kw = dict(dtype=like.dtype, device=like.device)
    if bounds is None:
        return torch.full((k,), -torch.inf, **kw), torch.full((k,), torch.inf, **kw)
    lo = torch.as_tensor(bounds[0], **kw).expand(k)
    hi = torch.as_tensor(bounds[1], **kw).expand(k)
    return lo, hi


def _proj_grad_norm(x: Tensor, g: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    return torch.amax(torch.abs(x - torch.clamp(x - g, lo, hi)), dim=-1)


def lbfgs_init(
    fun: Callable[[Tensor], Tensor],
    x0: Tensor,
    bounds: Optional[tuple] = None,
    history: int = 10,
    tol: float = 1e-5,
) -> LBFGSState:
    """Initial solver state for the lanes `x0: (r, k)`."""
    r, k = x0.shape
    lo, hi = _resolve_bounds(bounds, k, x0)
    x0 = torch.clamp(x0, lo, hi)
    f0, g0 = value_and_grad(fun, x0)
    kw = dict(dtype=x0.dtype, device=x0.device)
    ikw = dict(dtype=torch.int64, device=x0.device)
    return LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        S=torch.zeros((r, history, k), **kw),
        Y=torch.zeros((r, history, k), **kw),
        rho=torch.zeros((r, history), **kw),
        head=torch.zeros((r,), **ikw),
        n_iter=torch.zeros((r,), **ikw),
        n_fev=torch.ones((r,), **ikw),
        t_prev=torch.ones((r,), **kw),
        stall=torch.zeros((r,), **ikw),
        converged=_proj_grad_norm(x0, g0, lo, hi) <= tol,
        failed=torch.zeros((r,), dtype=torch.bool, device=x0.device),
    )


def _select(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def _step(fun, st: LBFGSState, lo, hi, tol, ftol, max_ls, ls) -> LBFGSState:
    """One iteration for every lane; finished lanes are left unchanged."""
    history = st.S.shape[1]
    done = st.converged | st.failed
    project = lambda x: torch.clamp(x, lo, hi)  # noqa: E731
    noise_floor = 4.0 * torch.finfo(st.x.dtype).eps
    c1 = 1e-4

    d = _two_loop(st.g, st.S, st.Y, st.rho, st.head)
    dg = _dot(d, st.g)
    # Steepest descent where d is not a descent direction.
    bad = (dg >= 0) | ~torch.isfinite(d).all(dim=-1)
    d = _select(bad, -st.g, d)
    dg = torch.where(bad, -_dot(st.g, st.g), dg)

    def armijo(f_new, x_new):
        return f_new <= st.f + c1 * _dot(st.g, x_new - st.x)

    # Projected backtracking Armijo line search (value-only trials).
    if ls == "interp":
        t = torch.clamp(4.0 * st.t_prev, max=1.0)
    else:
        t = torch.ones_like(st.t_prev)
    x_new = project(st.x + t[:, None] * d)
    f_new = _value(fun, x_new)
    it = torch.zeros_like(st.n_iter)
    searching = ~armijo(f_new, x_new) & (it < max_ls) & ~done
    while bool(searching.any()):
        if ls == "interp":
            denom = f_new - st.f - t * dg
            t_q = -0.5 * dg * t * t / torch.clamp(denom, min=1e-30)
            t_try = torch.where(
                torch.isfinite(f_new) & (denom > 0),
                torch.clamp(t_q, 0.1 * t, 0.5 * t),
                0.1 * t,
            )
        else:
            t_try = torch.where(torch.isfinite(f_new), 0.5 * t, 0.1 * t)
        x_try = project(st.x + t_try[:, None] * d)
        f_try = _value(fun, x_try)
        t = torch.where(searching, t_try, t)
        x_new = _select(searching, x_try, x_new)
        f_new = torch.where(searching, f_try, f_new)
        it = it + searching.to(it.dtype)
        searching = ~armijo(f_new, x_new) & (it < max_ls) & ~done

    # A non-finite objective or a failed search ends the lane (x kept).
    progressed = armijo(f_new, x_new) & torch.isfinite(f_new)
    f_acc, g_acc = value_and_grad(fun, x_new)

    s = x_new - st.x
    y = g_acc - st.g
    sy = _dot(s, y)
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)  # noqa: E731
    good_pair = progressed & (sy > 1e-10 * norm(s) * norm(y))
    lanes = torch.arange(st.x.shape[0], device=st.x.device)
    slot = st.head % history
    S = st.S.clone()
    Y = st.Y.clone()
    rho = st.rho.clone()
    S[lanes, slot] = s
    Y[lanes, slot] = y
    rho[lanes, slot] = 1.0 / torch.clamp(sy, min=1e-30)
    S = _select(good_pair, S, st.S)
    Y = _select(good_pair, Y, st.Y)
    rho = _select(good_pair, rho, st.rho)
    head = torch.where(good_pair, (st.head + 1) % history, st.head)

    x1 = _select(progressed, x_new, st.x)
    f1 = torch.where(progressed, f_acc, st.f)
    g1 = _select(progressed, g_acc, st.g)

    fscale = torch.clamp(torch.maximum(torch.abs(st.f), torch.abs(f1)), min=1.0)
    material = (st.f - f1) > max(ftol, noise_floor) * fscale
    stall = torch.where(material, 0, st.stall + 1)
    converged = (_proj_grad_norm(x1, g1, lo, hi) <= tol) | (stall >= 3)
    new = LBFGSState(
        x=x1, f=f1, g=g1, S=S, Y=Y, rho=rho, head=head,
        n_iter=st.n_iter + 1,
        # 1 initial trial + backtracks (value-only) + 1 value_and_grad
        n_fev=st.n_fev + 2 + it,
        t_prev=torch.where(progressed, t, st.t_prev),
        stall=stall,
        converged=converged,
        failed=~progressed,
    )
    return LBFGSState(*(_select(done, old, upd) for old, upd in zip(st, new)))


def lbfgs_run(
    fun: Callable[[Tensor], Tensor],
    init: LBFGSState,
    bounds: Optional[tuple] = None,
    iter_limit: int = 100,
    tol: float = 1e-5,
    ftol: float = 0.0,
    max_ls: int = 25,
    ls: str = "halving",
) -> LBFGSState:
    """Advance every lane until it converges, fails, or its iteration count
    reaches `iter_limit`."""
    if ls not in ("halving", "interp"):
        raise ValueError(f"unknown line search {ls!r}")
    lo, hi = _resolve_bounds(bounds, init.x.shape[-1], init.x)
    st = init
    while True:
        active = ~(st.converged | st.failed) & (st.n_iter < iter_limit)
        if not bool(active.any()):
            return st
        st = _step(fun, st, lo, hi, tol, ftol, max_ls, ls)


def multi_start_lbfgsb(
    fun: Callable[[Tensor], Tensor],
    x0_batch: Tensor,
    bounds: Optional[tuple] = None,
    maxiter: int = 100,
    history: int = 10,
    tol: float = 1e-5,
    max_ls: int = 25,
    ls: str = "halving",
) -> LBFGSResult:
    """Run L-BFGS-B from the starts `x0_batch: (r, k)` in lockstep; `fun`
    maps `(r, k) -> (r,)`."""
    st = lbfgs_init(fun, x0_batch, bounds=bounds, history=history, tol=tol)
    final = lbfgs_run(
        fun, st, bounds=bounds, iter_limit=maxiter, tol=tol, max_ls=max_ls, ls=ls
    )
    return LBFGSResult(
        x=final.x, fun=final.f, grad=final.g, n_iter=final.n_iter,
        n_fev=final.n_fev, converged=final.converged,
    )


def lbfgsb(
    fun: Callable[[Tensor], Tensor],
    x0: Tensor,
    bounds: Optional[tuple] = None,
    maxiter: int = 100,
    history: int = 10,
    tol: float = 1e-5,
    ftol: float = 0.0,
    max_ls: int = 25,
    ls: str = "halving",
) -> LBFGSResult:
    """Minimize `fun` from one start `x0: (k,)` subject to `lo <= x <= hi`.
    `fun` is batched as for `multi_start_lbfgsb` (it sees one lane)."""
    st = lbfgs_init(fun, x0[None], bounds=bounds, history=history, tol=tol)
    final = lbfgs_run(
        fun, st, bounds=bounds, iter_limit=maxiter, tol=tol, ftol=ftol,
        max_ls=max_ls, ls=ls,
    )
    return LBFGSResult(
        x=final.x[0], fun=final.f[0], grad=final.g[0], n_iter=final.n_iter[0],
        n_fev=final.n_fev[0], converged=final.converged[0],
    )
