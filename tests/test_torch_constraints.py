"""Port parity for constrained acquisition optimization
(`optim/constraints.py`, the polytope part of `utils/sampling.py` and the
constraint arguments of `optimize_acqf`) against botorch_tpu on the CPU.

* The dense constraint rows (duplicate indices add up, 2-d indices give
  inter-point rows) are equal. `AffineSubspace` is compared by its
  projector `N N^T`, `pinv` and `x0` (the basis itself is defined only up
  to rotation) within 1e-6: both factor in float64 on the host and round to
  float32.
* The Dykstra polish, `linear_violation` and the augmented Lagrangian's
  values and gradients at fixed multipliers within 1e-5 (float32 sums in
  another order).
* The samplers from the JAX package's own draws, replayed from its key
  splits (JAX and torch draws never match): hit-and-run within 1e-5 over
  a 520-step chain, `get_polytope_samples` with and without equalities,
  the Delaunay sampler within 1e-6.
* `optimize_acqf` on each constrained branch from the same initial
  conditions: candidates within 1e-2 (as the unconstrained q = 4 ascent's:
  float32 ascents stop along flat directions, here the equality manifold),
  each restart's value within 1e-3 or above the JAX package's, the best
  value within 1e-3, and both sides' violation <= 1e-5.
* Lane independence of the AL solve, and the fallback when no restart is
  feasible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import analytic as ja
from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.models import gp as jgp
from botorch_tpu.optim import constraints as jc
from botorch_tpu.optim import optimize as jo
from botorch_tpu.utils import sampling as js
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import analytic as ta
from botorch_tpu_torch.acquisition import monte_carlo as tmc
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.optim import constraints as tc
from botorch_tpu_torch.optim import optimize as to
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.utils import sampling as ts
from _torch_threads import _one_torch_thread  # noqa: F401

EQ3 = [((0, 1, 2), (1.0, 1.0, 1.0), 1.0)]
X0_LE_HALF = [((0,), (-1.0,), -0.5)]
BUDGET = [(((0, 0), (0, 1), (1, 0), (1, 1)), (-1.0, -1.0, -1.0, -1.0), -1.2)]


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------- #
ROW_CASES = {
    "duplicates": ([((0, 0), (1.0, 1.0), 1.0), ((2, 0, 2), (0.5, -1.0, 2.0), -0.3)], 2, 3),
    "interpoint": ([(((0, 0), (1, 0)), (1.0, -1.0), 0.0), ((1,), (2.0,), 0.4),
                    (((0, 1), (0, 1), (1, 2)), (1.0, 2.0, -1.0), 0.5)], 2, 3),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_dense_rows_match_reference(case):
    cons, q, d = ROW_CASES[case]
    np.testing.assert_array_equal(tc._dense_rows_flat(cons, q, d)[0],
                                  jc._dense_rows_flat(cons, q, d)[0])
    np.testing.assert_array_equal(tc._dense_rows_flat(cons, q, d)[1],
                                  jc._dense_rows_flat(cons, q, d)[1])
    assert tc.is_interpoint(cons) == jc.is_interpoint(cons) == (case == "interpoint")
    if case == "duplicates":
        A, b = tc._dense_rows(cons, d)
        np.testing.assert_array_equal(A, [[2.0, 0.0, 0.0], [-1.0, 0.0, 2.5]])
        np.testing.assert_array_equal(A, jc._dense_rows(cons, d)[0])
        np.testing.assert_array_equal(b, jc._dense_rows(cons, d)[1])
    else:
        with pytest.raises(ValueError, match="inter-point"):
            tc._dense_rows(cons, d)
    assert tc._dense_rows_flat([], 2, 3)[0].shape == (0, 6)


AFFINE_CASES = {
    "simplex": (np.array([[1.0, 1.0, 1.0]]), np.array([1.0])),
    "two_rows": (np.array([[1.0, -2.0, 0.5, 0.0], [0.0, 1.0, 1.0, 1.0]]), np.array([0.2, 1.5])),
    # an intra-point row expanded over q = 2 plus a consistent inter-point tie
    "redundant": tc._dense_rows_flat([((0,), (1.0,), 0.5), (((0, 0), (1, 0)), (1.0, -1.0), 0.0)],
                                     2, 2),
}


@pytest.mark.parametrize("case", sorted(AFFINE_CASES))
def test_affine_subspace_matches_reference(case):
    A, b = AFFINE_CASES[case]
    aj = jc.AffineSubspace.from_dense(A, b)
    at = tc.AffineSubspace.from_dense(A, b, device="cpu")
    assert at.basis.dtype == torch.float32 and at.basis.shape == aj.basis.shape
    for f in ("A", "b", "pinv", "x0"):
        np.testing.assert_allclose(_np(getattr(at, f)), np.asarray(getattr(aj, f)), atol=1e-6)
    Nj, Nt = np.asarray(aj.basis), _np(at.basis)
    np.testing.assert_allclose(Nt @ Nt.T, Nj @ Nj.T, atol=1e-6)
    x = np.random.default_rng(0).uniform(size=(7, A.shape[1])).astype(np.float32)
    np.testing.assert_allclose(_np(at.project(torch.tensor(x))), np.asarray(aj.project(x)),
                               atol=1e-6)
    np.testing.assert_allclose(_np(at.violation(torch.tensor(x))), np.asarray(aj.violation(x)),
                               atol=1e-6)
    assert float(at.violation(at.project(torch.tensor(x))).max()) <= 1e-6
    a64 = tc.AffineSubspace.from_dense(A, b, dtype=torch.float64, device="cpu")
    assert a64.pinv.dtype == torch.float64


def test_inconsistent_equalities_raise():
    A, b = tc._dense_rows_flat([((0,), (1.0,), 0.5), ((0,), (1.0,), 0.8)], 1, 2)
    with pytest.raises(ValueError, match="inconsistent"):
        tc.AffineSubspace.from_dense(A, b, device="cpu")


@pytest.mark.parametrize("with_halfspaces", [False, True])
def test_dykstra_projection_matches_reference(with_halfspaces):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 1.5, size=(9, 6)).astype(np.float32)
    A_eq, b_eq = tc._dense_rows_flat(EQ3, 2, 3)
    lo, hi = np.zeros(6, np.float32), np.ones(6, np.float32)
    A_in, b_in = tc._dense_rows_flat(X0_LE_HALF + [((1, 2), (1.0, -1.0), -0.1)], 2, 3)
    kw_j = dict(A_ineq=jnp.asarray(A_in, jnp.float32), b_ineq=jnp.asarray(b_in, jnp.float32)) \
        if with_halfspaces else {}
    kw_t = dict(A_ineq=torch.tensor(A_in, dtype=torch.float32),
                b_ineq=torch.tensor(b_in, dtype=torch.float32)) if with_halfspaces else {}
    pj = jc.project_box_affine_halfspaces(jnp.asarray(x), lo, hi,
                                          affine=jc.AffineSubspace.from_dense(A_eq, b_eq), **kw_j)
    pt = tc.project_box_affine_halfspaces(torch.tensor(x), torch.tensor(lo), torch.tensor(hi),
                                          affine=tc.AffineSubspace.from_dense(A_eq, b_eq,
                                                                              device="cpu"),
                                          **kw_t)
    np.testing.assert_allclose(_np(pt), np.asarray(pj), atol=1e-5)
    assert np.abs(_np(pt) @ A_eq.T - b_eq).max() <= 1e-5


def test_linear_violation_matches_reference():
    Xq = np.random.default_rng(2).uniform(size=(11, 2, 3)).astype(np.float32)
    for ineq, eq in ((X0_LE_HALF, None), (None, EQ3), (X0_LE_HALF, EQ3),
                     ([(((0, 0), (1, 2)), (1.0, 1.0), 1.1)], [(((0, 1), (1, 1)), (1.0, -1.0), 0.0)]),
                     (None, None)):
        vt = tc.linear_violation(torch.tensor(Xq), ineq, eq)
        vj = jc.linear_violation(jnp.asarray(Xq), ineq, eq)
        assert vt.shape == (11,)
        np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=1e-6)


def _al_pair():
    """The same AL pieces in both packages: q = 2, d = 3, an equality, an
    intra- and an inter-point inequality, an intra- and an inter-point
    nonlinear constraint, and a smooth objective."""
    q, d = 2, 3
    w = np.array([0.3, -1.0, 0.7, 0.2, 0.5, -0.4], np.float32)
    nl_j = [lambda x: 0.8 - jnp.sum(x * x), (lambda X: X[0, 0] * X[1, 1] - 0.1, False)]
    nl_t = [lambda x: 0.8 - torch.sum(x * x, dim=-1),
            (lambda X: X[..., 0, 0] * X[..., 1, 1] - 0.1, False)]
    cons = dict(inequality_constraints=X0_LE_HALF + [(((0, 2), (1, 0)), (1.0, 1.0), 0.6)],
                equality_constraints=[((0, 1, 2), (1.0, 1.0, 1.0), 1.2)])
    neg_j = lambda v: -jnp.sum(jnp.sin(3.0 * v) * w)  # noqa: E731
    neg_t = lambda V: -torch.sum(torch.sin(3.0 * V) * torch.tensor(w), dim=-1)  # noqa: E731
    j = jc.make_al_objective(neg_j, q, d, nonlinear_inequality_constraints=nl_j, **cons)
    t = tc.make_al_objective(neg_t, q, d, nonlinear_inequality_constraints=nl_t, device="cpu",
                             **cons)
    return j, t


def test_al_objective_values_and_grads_match_reference():
    (al_j, neq_j, nin_j, cv_j), (al_t, neq_t, nin_t, cv_t) = _al_pair()
    assert (neq_t, nin_t) == (neq_j, nin_j) == (2, 2 + 1 + 2 + 1)
    rng = np.random.default_rng(3)
    V = rng.uniform(size=(5, 6)).astype(np.float32)
    lam = rng.normal(size=(5, neq_j)).astype(np.float32)
    mu = np.abs(rng.normal(size=(5, nin_j))).astype(np.float32)
    for rho in (10.0, 1000.0):
        vj, gj = jax.vmap(jax.value_and_grad(al_j), in_axes=(0, 0, 0, None))(
            jnp.asarray(V), jnp.asarray(lam), jnp.asarray(mu), jnp.float32(rho))
        Vt = torch.tensor(V, requires_grad=True)
        vt = al_t(Vt, torch.tensor(lam), torch.tensor(mu), rho)
        (gt,) = torch.autograd.grad(vt.sum(), Vt)
        np.testing.assert_allclose(_np(vt), np.asarray(vj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(gj)).max()))
    hj, cj = jax.vmap(cv_j)(jnp.asarray(V))
    ht, ct = cv_t(torch.tensor(V))
    np.testing.assert_allclose(_np(ht), np.asarray(hj), atol=1e-6)
    np.testing.assert_allclose(_np(ct), np.asarray(cj), atol=1e-6)


# --------------------------------------------------------------------- #
def _hit_and_run_draws(key, steps: int, d: int):
    """The JAX package's per-step draws of `sample_polytope`, replayed from
    its key splits: a normal direction and a uniform per step."""
    ks = jax.vmap(jax.random.split)(jax.random.split(key, steps))
    dirs = jax.vmap(lambda k: jax.random.normal(k, (d,)))(ks[:, 0])
    us = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=1.0))(ks[:, 1])
    return torch.tensor(np.asarray(dirs)), torch.tensor(np.asarray(us))


def _box_rows(d: int, extra):
    A, b = [], []
    for i in range(d):
        A += [-np.eye(d)[i], np.eye(d)[i]]
        b += [0.0, 1.0]
    for row, rhs in extra:
        A.append(np.asarray(row, np.float64))
        b.append(rhs)
    return np.stack(A), np.asarray(b)


def test_find_interior_point_matches_reference():
    A, b = _box_rows(3, [([1.0, 1.0, 1.0], 1.0)])
    np.testing.assert_allclose(ts.find_interior_point(A, b), js.find_interior_point(A, b),
                               atol=1e-9)
    bounds = np.array([[0.0, 0.0, 0.0], [0.5, 1.0, 1.0]])
    np.testing.assert_allclose(ts.find_interior_point(A, b, bounds),
                               js.find_interior_point(A, b, bounds), atol=1e-9)
    with pytest.raises(ValueError, match="empty"):
        ts.find_interior_point(*_box_rows(2, [([1.0, 1.0], -0.5)]))


def test_sample_polytope_from_reference_draws():
    A, b = _box_rows(3, [([1.0, 1.0, 1.0], 1.2), ([-1.0, 0.0, 0.0], -0.1)])
    x0 = js.find_interior_point(A, b)
    key = jax.random.PRNGKey(7)
    n, burn, thin = 10, 200, 32
    pj = js.sample_polytope(jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
                            jnp.asarray(x0, jnp.float32), key, n=n, n_burnin=burn, thinning=thin)
    dirs, us = _hit_and_run_draws(key, burn + n * thin, 3)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    pt = ts.sample_polytope(f32(A), f32(b), f32(x0), n=n, n_burnin=burn, thinning=thin,
                            directions=dirs, uniforms=us)
    assert pt.shape == (n, 3)
    np.testing.assert_allclose(_np(pt), np.asarray(pj), atol=1e-5)
    assert (_np(pt) @ A.T <= b + 1e-6).all()
    with pytest.raises(ValueError, match="generator"):
        ts.sample_polytope(f32(A), f32(b), f32(x0), n=2)
    own = ts.sample_polytope(f32(A), f32(b), f32(x0), n=64, generator=make_generator(0, "cpu"))
    assert (_np(own) @ A.T <= b + 1e-6).all() and _np(own).std(0).min() > 0.05


@pytest.mark.parametrize("with_equality", [False, True])
def test_get_polytope_samples_from_reference_draws(with_equality):
    bounds = np.stack([np.zeros(3), np.ones(3)]).astype(np.float32)
    ineq = [((0,), (1.0,), 0.1)]
    eq = [((0, 1, 2), (1.0, 1.0, 1.0), 1.5)] if with_equality else None
    key = jax.random.PRNGKey(4)
    n = 24
    pj = js.get_polytope_samples(key, n, jnp.asarray(bounds), inequality_constraints=ineq,
                                 equality_constraints=eq)
    dirs, us = _hit_and_run_draws(key, 200 + n * 32, 2 if with_equality else 3)
    pt = ts.get_polytope_samples(None, n, torch.tensor(bounds), inequality_constraints=ineq,
                                 equality_constraints=eq, directions=dirs, uniforms=us)
    assert pt.shape == (n, 3) and pt.dtype == torch.float32
    np.testing.assert_allclose(_np(pt), np.asarray(pj), atol=1e-5)
    P = _np(pt)
    assert (P[:, 0] >= 0.1 - 1e-5).all() and (P >= -1e-5).all() and (P <= 1 + 1e-5).all()
    if with_equality:
        np.testing.assert_allclose(P.sum(-1), 1.5, atol=1e-5)
    sob = ts.get_polytope_samples(make_generator(0, "cpu"), 8, torch.tensor(bounds))
    assert sob.shape == (8, 3) and bool(((sob >= 0) & (sob <= 1)).all())


@pytest.mark.parametrize("d", [1, 2, 3])
def test_sample_polytope_delaunay_from_reference_draws(d):
    A, b = _box_rows(d, [([1.0] * d, 0.9 if d > 1 else 0.7)])
    key = jax.random.PRNGKey(d)
    n = 16
    pj = js.sample_polytope_delaunay(jnp.asarray(A), jnp.asarray(b), key, n=n)
    k_s, k_w = jax.random.split(key)
    if d == 1:
        idx, u = None, jax.random.uniform(key, (n, 1))
    else:
        from scipy.spatial import Delaunay, HalfspaceIntersection

        verts = HalfspaceIntersection(np.c_[A, -b], js.find_interior_point(A, b)).intersections
        simp = verts[Delaunay(verts).simplices]
        vols = np.abs(np.linalg.det(simp[:, 1:, :] - simp[:, :1, :]))
        idx = jax.random.choice(k_s, len(vols), (n,),
                                p=jnp.asarray(vols / vols.sum(), jnp.float32))
        idx = torch.tensor(np.asarray(idx))
        u = jax.random.uniform(k_w, (n, d))
    pt = ts.sample_polytope_delaunay(A, b, n=n, simplex_index=idx,
                                     uniforms=torch.tensor(np.asarray(u)), device="cpu")
    np.testing.assert_allclose(_np(pt), np.asarray(pj), atol=1e-6)
    own = ts.sample_polytope_delaunay(A, b, n=n, generator=make_generator(1, "cpu"))
    assert own.shape == (n, d) and (_np(own) @ A.T <= b + 1e-5).all()


def test_sphere_simplex_and_multinomial():
    g = make_generator(0, "cpu")
    s = ts.sample_hypersphere(g, 4, 50)
    np.testing.assert_allclose(_np(torch.linalg.vector_norm(s, dim=-1)), 1.0, atol=1e-6)
    z = torch.randn((50, 4), generator=make_generator(0, "cpu"))
    torch.testing.assert_close(s, z / z.norm(dim=-1, keepdim=True))
    u = np.random.default_rng(0).uniform(size=(9, 3)).astype(np.float32)
    w = ts.sample_simplex(None, 4, uniforms=torch.tensor(u))
    np.testing.assert_allclose(_np(w), np.diff(np.sort(u, -1), prepend=0.0, append=1.0,
                                               axis=-1), atol=1e-7)
    assert ts.sample_simplex(g, 5, 7).shape == (7, 5)
    weights = torch.tensor([[0.0, 1.0, 2.0, 0.0, 3.0]] * 4)
    idx = ts.batched_multinomial(g, weights, 3)
    assert idx.shape == (4, 3)
    for row in idx.tolist():  # without replacement, never a zero-weight entry
        assert sorted(row) == [1, 2, 4]


# --------------------------------------------------------------------- #
def _gp_pair(X, Y, lengthscales, noise=1e-2):
    """The same GP in both packages at fixed hyperparameters, each with its
    train cache (the JAX one jitted: eagerly it compiles op by op)."""
    m = Y.shape[1]
    pn = {"mean": np.zeros(m, np.float32),
          "raw_lengthscale": np.log(np.asarray(lengthscales, np.float32)),
          "raw_outputscale": np.zeros(m, np.float32),
          "raw_noise": np.log(np.full(m, noise, np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y, device="cpu", params=convert.gp_params_from_numpy(pn))
    return (jm, jax.jit(lambda mdl: mdl.train_chol())(jm)), (tm, tm.train_chol())


def _branch(name):
    """(JAX acqf, port acqf, q, d, JAX kwargs, port kwargs) of one constrained
    branch: example 06's outcome-constrained qLogEI under x0 + x1 >= 0.5
    (polytope; 32 MC samples here, 128 in the example), example 12's LogEI
    on the simplex with x0 <= 0.5 (polytope, with an equality), the
    inter-point budget, an intra-point nonlinear constraint 1 - |x|^2 >= 0."""
    rng = np.random.default_rng(0)
    if name == "outcome_qlogei":
        X = rng.uniform(size=(15, 2)).astype(np.float32)
        Y = np.stack([np.sin(5 * X[:, 0]) + X[:, 1], X[:, 0] - 0.6], -1).astype(np.float32)
        (jm, jcache), (tm, tcache) = _gp_pair(X, Y, [[0.3, 0.4], [0.5, 0.5]])
        kw = dict(best_f=float(np.max(np.where(Y[:, 1] <= 0, Y[:, 0], -np.inf))),
                  constraints=(lambda s: s[..., 1],))
        at = tmc.make_mc_acqf(tmc.qLogExpectedImprovement, tm, q=1, num_samples=32, **kw)
        aj = jmc.qLogExpectedImprovement(model=jm, cache=jcache,
                                         base_samples=jnp.asarray(_np(at.base_samples)), **kw)
        cons = dict(inequality_constraints=[((0, 1), (1.0, 1.0), 0.5)])
        return aj, at, 1, 2, cons, cons
    if name == "interpoint_budget":
        cons = dict(inequality_constraints=BUDGET)
        return (lambda X: jnp.sum(X)), (lambda X: X.sum((-1, -2))), 2, 2, cons, cons
    if name == "simplex_logei":
        X = rng.dirichlet(np.ones(3), size=20).astype(np.float32)
        Y = (np.sin(4 * X[:, 0]) + X[:, 1] - 0.5 * X[:, 2]
             + 0.05 * rng.normal(size=20)).astype(np.float32)[:, None]
        cons_j = cons_t = dict(equality_constraints=EQ3, inequality_constraints=X0_LE_HALF)
    else:
        X = rng.uniform(size=(16, 3)).astype(np.float32)
        Y = (-np.sum((X - 0.6) ** 2, -1)).astype(np.float32)[:, None]
        cons_j = dict(nonlinear_inequality_constraints=[lambda x: 1.0 - jnp.sum(x * x)])
        cons_t = dict(nonlinear_inequality_constraints=[lambda x: 1.0 - torch.sum(x * x, -1)])
    (jm, jcache), (tm, tcache) = _gp_pair(X, Y, [[0.3, 0.4, 0.5]])
    aj = ja.LogExpectedImprovement(model=jm, cache=jcache, best_f=float(Y.max()))
    at = ta.LogExpectedImprovement(model=tm, cache=tcache, best_f=float(Y.max()))
    return aj, at, 1, 3, cons_j, cons_t


BRANCHES = ("outcome_qlogei", "simplex_logei", "interpoint_budget", "nonlinear_ball")


@pytest.fixture(scope="module")
def branches():
    return {name: _branch(name) for name in BRANCHES}


@pytest.mark.parametrize("name", BRANCHES)
def test_constrained_optimize_acqf_matches_reference(branches, name):
    aj, at, q, d, kw_j, kw_t = branches[name]
    ics = np.random.default_rng(5).uniform(size=(4, q, d)).astype(np.float32)
    bounds = np.stack([np.zeros(d), np.ones(d)]).astype(np.float32)
    cj, vj = jo.optimize_acqf(aj, jnp.asarray(bounds), q=q, initial_conditions=jnp.asarray(ics),
                              maxiter=20, return_full=True, **kw_j)
    ct, vt = to.optimize_acqf(at, bounds, q=q, initial_conditions=ics, maxiter=20,
                              return_full=True, device="cpu", **kw_t)
    assert ct.shape == (4, q, d) and vt.shape == (4,)
    np.testing.assert_allclose(_np(ct), np.asarray(cj), atol=1e-2)
    # a lane may stop at another place along a flat direction (example 12's
    # equality manifold: 5.6e-3 apart in value at lane 0, the port higher):
    # each lane's value is within 1e-3 of the JAX package's or above it, and
    # the best restart's value within 1e-3
    vt_, vj_ = _np(vt), np.asarray(vj)
    close = np.isclose(vt_, vj_, rtol=1e-3, atol=1e-3) | (vt_ >= vj_)
    assert close.all(), (vt_, vj_)
    np.testing.assert_allclose(vt_.max(), vj_.max(), rtol=1e-3, atol=1e-3)
    # every restart that keeps a value is feasible, on both sides
    lin = {k: v for k, v in kw_t.items() if k != "nonlinear_inequality_constraints"}
    for c, v in ((_np(ct), vt_), (np.asarray(cj), vj_)):
        kept = torch.tensor(c[np.isfinite(v)])
        assert len(kept) > 0
        assert float(tc.linear_violation(kept, **lin).max()) <= 1e-5
        if name == "nonlinear_ball":
            assert float((kept ** 2).sum(-1).max()) <= 1.0 + 1e-5
    best, val = to.optimize_acqf(at, bounds, q=q, initial_conditions=ics, maxiter=20,
                                 device="cpu", **kw_t)
    assert float(val) == pytest.approx(float(vt.max()))


@pytest.mark.parametrize("name", BRANCHES)
def test_constrained_initial_conditions(branches, name):
    """Each branch's own raw q-batches and their screening scores: in the
    box; the polytope branch's satisfy the linear constraints and keep the
    acquisition value; the others' are the value less 1e3 times the squared
    violation."""
    _, at, q, d, _, kw_t = branches[name]
    bounds = torch.stack([torch.zeros(d), torch.ones(d)])
    X_raw, scores = to._constrained_raw_candidates(
        at, bounds, q, 16, make_generator(0, "cpu"), kw_t.get("inequality_constraints"),
        kw_t.get("equality_constraints"), kw_t.get("nonlinear_inequality_constraints"), 1e3)
    assert X_raw.shape == (16, q, d) and scores.shape == (16,)
    assert bool(((X_raw >= -1e-5) & (X_raw <= 1 + 1e-5)).all())
    lin = {k: v for k, v in kw_t.items() if k != "nonlinear_inequality_constraints"}
    viol = tc.linear_violation(X_raw, **lin)
    if name in ("outcome_qlogei", "simplex_logei"):
        assert float(viol.max()) <= 1e-5
        torch.testing.assert_close(scores, at(X_raw))
    elif name == "interpoint_budget":
        torch.testing.assert_close(scores, at(X_raw) - 1e3 * viol ** 2)
    else:
        pen = torch.clamp(1.0 - (X_raw ** 2).sum(-1), max=0.0) ** 2
        torch.testing.assert_close(scores, at(X_raw) - 1e3 * pen.sum(-1))
    cand, val = to.optimize_acqf(at, bounds, q=q, num_restarts=3, raw_samples=16, maxiter=10,
                                 generator=make_generator(1, "cpu"), device="cpu", **kw_t)
    assert cand.shape == (q, d) and bool(torch.isfinite(val))


def test_al_lanes_are_independent(branches):
    """A lane's multipliers see only its own constraint values: lane 0's
    result does not change when the other lanes start elsewhere (one of
    them far outside the feasible set)."""
    at = branches["simplex_logei"][1]
    cons = dict(equality_constraints=EQ3, inequality_constraints=X0_LE_HALF,
                nonlinear_inequality_constraints=[lambda x: 0.9 - torch.sum(x * x, dim=-1)])
    rng = np.random.default_rng(9)
    ics = rng.uniform(size=(4, 1, 3)).astype(np.float32)
    other = ics.copy()
    other[1:] = rng.uniform(size=(3, 1, 3))
    other[2] = 1.0
    bounds = [[0.0] * 3, [1.0] * 3]
    ca, va = to.optimize_acqf(at, bounds, q=1, initial_conditions=ics, maxiter=20,
                              return_full=True, device="cpu", **cons)
    cb, vb = to.optimize_acqf(at, bounds, q=1, initial_conditions=other, maxiter=20,
                              return_full=True, device="cpu", **cons)
    assert not torch.equal(ca[1:], cb[1:])
    torch.testing.assert_close(cb[0], ca[0], rtol=0, atol=1e-7)
    torch.testing.assert_close(vb[0], va[0], rtol=0, atol=1e-7)


def test_no_feasible_restart_falls_back_like_reference():
    """An unsatisfiable nonlinear constraint: every restart is infeasible,
    and the least infeasible one alone keeps its (finite) value."""
    ics = np.random.default_rng(3).uniform(size=(4, 1, 2)).astype(np.float32)
    bounds = np.stack([np.zeros(2), np.ones(2)]).astype(np.float32)
    cj, vj = jo.optimize_acqf(lambda X: -jnp.sum((X - 0.5) ** 2), jnp.asarray(bounds), q=1,
                              initial_conditions=jnp.asarray(ics), maxiter=20, return_full=True,
                              nonlinear_inequality_constraints=[lambda x: -1.0 - jnp.sum(x ** 2)])
    ct, vt = to.optimize_acqf(lambda X: -((X - 0.5) ** 2).sum((-1, -2)), bounds, q=1,
                              initial_conditions=ics, maxiter=20, return_full=True, device="cpu",
                              nonlinear_inequality_constraints=[lambda x: -1.0 - (x ** 2).sum(-1)])
    vj = np.asarray(vj)
    assert np.isfinite(_np(vt)).sum() == 1 and np.isfinite(vj).sum() == 1
    k = int(np.argmax(np.isfinite(vj)))
    assert int(torch.argmax(vt)) == k
    np.testing.assert_allclose(_np(ct[k]), np.asarray(cj[k]), atol=1e-3)
    np.testing.assert_allclose(float(vt[k]), float(vj[k]), atol=1e-3)
