"""Port parity for `ops/lbfgs.py`: the batched L-BFGS-B of
botorch_tpu_torch against botorch_tpu's vmapped solver on the same starts.

In float64 the two must take the same steps: same iterates (rtol 1e-7,
what different summation orders in the two-loop recursion leave after
tens of iterations), and identical iteration and evaluation counts per
lane, for both line searches and with lanes that finish at different
times (frozen lanes). In float32 the GP MAP fit is compared on its result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.ops import lbfgs as jl
from botorch_tpu_torch.ops import lbfgs as tl
from _torch_threads import _one_torch_thread  # noqa: F401


def rosen_t(X):
    return torch.sum(100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2 + (1.0 - X[:, :-1]) ** 2, dim=-1)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def quad_t(X):  # lanes converge at different iterations
    w = torch.arange(1, X.shape[-1] + 1, dtype=X.dtype)
    return torch.sum(w * (X - 0.3) ** 2, dim=-1) + 0.1 * torch.sum(X**4, dim=-1)


def quad_j(x):
    w = jnp.arange(1, x.shape[-1] + 1, dtype=x.dtype)
    return jnp.sum(w * (x - 0.3) ** 2) + 0.1 * jnp.sum(x**4)


def _run_both(ft, fj, x0, bounds, maxiter, ls):
    with jax.enable_x64(True):
        rj = jl.multi_start_lbfgsb(
            fj, jnp.asarray(x0), bounds=tuple(jnp.asarray(b) for b in bounds),
            maxiter=maxiter, ls=ls,
        )
        rj = jax.tree_util.tree_map(np.asarray, rj)
    rt = tl.multi_start_lbfgsb(
        ft, torch.tensor(x0), bounds=tuple(torch.tensor(b) for b in bounds),
        maxiter=maxiter, ls=ls,
    )
    return rt, rj


@pytest.mark.parametrize("ls", ["halving", "interp"])
@pytest.mark.parametrize("fn", ["rosenbrock", "quartic"])
def test_same_trajectory_float64(fn, ls):
    rng = np.random.default_rng(0)
    k = 4
    x0 = rng.uniform(-1.5, 1.5, size=(5, k))
    bounds = (np.full(k, -1.2), np.full(k, 1.1))  # the box is active for some lanes
    ft, fj = (rosen_t, rosen_j) if fn == "rosenbrock" else (quad_t, quad_j)
    rt, rj = _run_both(ft, fj, x0, bounds, maxiter=60, ls=ls)
    np.testing.assert_array_equal(rt.n_iter.numpy(), rj.n_iter)
    np.testing.assert_array_equal(rt.n_fev.numpy(), rj.n_fev)
    np.testing.assert_array_equal(rt.converged.numpy(), rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), rj.x, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(rt.fun.numpy(), rj.fun, rtol=1e-7, atol=1e-12)
    if fn == "quartic":
        assert len(set(rt.n_iter.tolist())) > 1  # lanes finished at different times


def test_single_start_lbfgsb():
    x0 = np.array([-1.0, 1.5, 0.2])
    r = tl.lbfgsb(rosen_t, torch.tensor(x0), maxiter=200)
    with jax.enable_x64(True):
        rj = jl.lbfgsb(rosen_j, jnp.asarray(x0), maxiter=200)
    assert r.x.shape == (3,) and int(r.n_iter) == int(rj.n_iter)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=1e-7)
    np.testing.assert_allclose(r.x.numpy(), np.ones(3), atol=1e-3)


def test_nonfinite_lane_is_frozen_not_spread():
    """A lane whose objective is NaN stops (failed) without touching the
    other lanes."""

    def f(X):
        v = quad_t(X)
        return torch.where(X[:, 0] > 5.0, torch.nan, v)

    x0 = torch.tensor([[6.0, 0.0], [0.9, -0.4]], dtype=torch.float64)
    r = tl.multi_start_lbfgsb(f, x0, maxiter=30)
    ref = tl.multi_start_lbfgsb(quad_t, x0[1:], maxiter=30)
    assert torch.isnan(r.fun[0]) and int(r.n_iter[0]) <= 1
    torch.testing.assert_close(r.x[1], ref.x[0], rtol=0, atol=0)
    assert int(r.n_fev[1]) == int(ref.n_fev[0])


def test_gp_map_fit_float32():
    """The GP MAP loss (the fit's objective) from the same starts."""
    from jax.flatten_util import ravel_pytree

    from botorch_tpu.fit import param_bounds as j_bounds
    from botorch_tpu.models import gp as jgp
    from botorch_tpu_torch import convert
    from botorch_tpu_torch.fit import param_bounds as t_bounds
    from botorch_tpu_torch.models import gp as tgp

    rng = np.random.default_rng(2)
    X = rng.uniform(size=(14, 2)).astype(np.float32)
    Y = (np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1])).astype(np.float32)
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y))
    tm = tgp.make_gp(X, Y, device="cpu")
    flat0, unravel = ravel_pytree(jm.params)
    x0 = np.stack([np.asarray(flat0), np.asarray(flat0) + np.float32(0.3)])
    lo, hi = (np.asarray(ravel_pytree(b)[0]) for b in j_bounds(jm))
    rj = jl.multi_start_lbfgsb(lambda v: jm.map_objective(unravel(v)), jnp.asarray(x0),
                               bounds=(jnp.asarray(lo), jnp.asarray(hi)), maxiter=15,
                               ls="interp")
    lo_t, hi_t = (convert.flatten_params(b) for b in t_bounds(tm))
    np.testing.assert_array_equal(lo_t.numpy(), lo)
    np.testing.assert_array_equal(hi_t.numpy(), hi)
    rt = tl.multi_start_lbfgsb(
        lambda V: tm.map_objective(convert.unflatten_params(V, tm.params)),
        torch.tensor(x0), bounds=(lo_t, hi_t), maxiter=15, ls="interp",
    )
    # float32 L-BFGS on a smooth surface: the final losses agree to ~1e-4
    # relative; the iterates to ~1e-2 in the flat directions
    np.testing.assert_allclose(rt.fun.numpy(), np.asarray(rj.fun), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=2e-2)
