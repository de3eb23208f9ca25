"""Port parity for the constrained acquisitions and problems against
botorch_tpu on the CPU, and the two constrained loops of `chip_smoke.py`.

* `log_prob_normal_in` and `standard_normal_log_hazard`, values and
  gradients, float32 within 1e-5 relative (the tails' `erfcx` series and
  `log1mexp` round alike in both), float64 within 1e-12.
* `LogConstrainedExpectedImprovement` and `ConstrainedExpectedImprovement`
  on a 3-output GP, two-sided, lower-only and upper-only: values within
  rtol 3e-4 and gradients within 3e-3 of their scale, as
  `test_torch_analytic.py` holds the unconstrained classes (the same
  float32 posterior of condition ~1e3). The JAX package's gradient is NaN
  wherever a bound is infinite (always, for the objective's column), so
  the port's finite gradient is held to the JAX package's with the
  infinite bounds replaced by +-1e30.
* The constrained test problems and the outcome-constraint helpers of
  `utils/constraints.py` within 1e-6; `estimate_feasible_volume` from the
  JAX package's uniforms exactly.
* The reference's dead fallback in `_NoisyMixin`: a sample with no
  feasible baseline point keeps a best of `-inf` in both packages.
* One step of each constrained loop (ConstrainedGramacy with LogCEI, the
  JAX side with +-1e30 for its infinite bounds; Hartmann-6 under
  sum(x) <= 3 with LogEI) from the JAX package's fit starts and given
  initial conditions: fitted raw hyperparameters and the
  candidate within 2e-2, the value within 2e-3 relative, as
  `test_torch_loop.py` holds the unconstrained step (15-step float32
  budgets stop short of convergence).
* Slow: both loops over 8 seeds against the JAX package's: the port's mean
  improvement over the initial design at least the reference's less half
  the reference's standard deviation over seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import analytic as ja
from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.fit import _prepare_fit as j_prepare_fit
from botorch_tpu.fit import fit_gp as j_fit_gp
from botorch_tpu.models import gp as jgp
from botorch_tpu.optim.optimize import optimize_acqf as j_optimize_acqf
from botorch_tpu.sampling.sobol import draw_sobol as j_draw_sobol
from botorch_tpu.sampling.sobol import sobol_table as j_sobol_table
from botorch_tpu.test_functions import extra as jx
from botorch_tpu.test_functions.synthetic import Hartmann as JHartmann
from botorch_tpu.utils import constraints as juc
from botorch_tpu.utils import probability as jp
from botorch_tpu.utils.sampling import get_polytope_samples as j_polytope
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import analytic as ta
from botorch_tpu_torch.acquisition import monte_carlo as tmc
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.models.fully_bayesian import load_saas_samples
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.test_functions import extra as tx
from botorch_tpu_torch.utils import constraints as tuc
from botorch_tpu_torch.utils import probability as tp

import chip_smoke as cs
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = cs.LOOP_CFG
INF = math.inf


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_log_prob_normal_in_and_log_hazard_match_reference(dtype):
    grid = np.array([-40.0, -9.0, -3.0, -1.0, -0.3, 0.0, 0.4, 1.5, 4.0, 9.0, 35.0])
    a, b = np.meshgrid(grid, grid, indexing="ij")
    keep = a < b
    a, b = a[keep].astype(dtype), b[keep].astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        fj = lambda u, v: jnp.sum(jp.log_prob_normal_in(u, v))  # noqa: E731
        vj, gj = jax.jit(jax.value_and_grad(fj, argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(b))
        vj = np.asarray(jax.jit(jp.log_prob_normal_in)(jnp.asarray(a), jnp.asarray(b)))
        gj = [np.asarray(g) for g in gj]
        hj = np.asarray(jax.jit(jp.standard_normal_log_hazard)(jnp.asarray(grid.astype(dtype))))
    at = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    vt = tp.log_prob_normal_in(at, bt)
    gt = torch.autograd.grad(vt.sum(), (at, bt))
    rtol = 1e-5 if dtype == "float32" else 1e-12
    assert np.isfinite(_np(vt)).all()
    np.testing.assert_allclose(_np(vt), vj, rtol=rtol, atol=rtol)
    for g_t, g_j in zip(gt, gj):
        np.testing.assert_allclose(_np(g_t), g_j, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(_np(tp.standard_normal_log_hazard(torch.tensor(grid.astype(dtype)))),
                               hj, rtol=rtol, atol=rtol)


@pytest.fixture(scope="module")
def models3():
    """A 3-output GP (objective and two constrained outputs) in both packages."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(15, 2)).astype(np.float32)
    Y = np.stack([np.sin(6 * X[:, 0]) + X[:, 1], X[:, 0] - X[:, 1], np.cos(3 * X[:, 1])],
                 -1).astype(np.float32)
    pn = {"mean": np.array([0.1, 0.0, -0.1], np.float32),
          "raw_lengthscale": np.log(np.array([[0.3, 0.5], [0.4, 0.4], [0.6, 0.3]], np.float32)),
          "raw_outputscale": np.zeros(3, np.float32),
          "raw_noise": np.log(np.array([1e-2, 2e-2, 1e-2], np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y, device="cpu", params=convert.gp_params_from_numpy(pn))
    return (jm, jax.jit(lambda m: m.train_chol())(jm)), (tm, tm.train_chol())


# (constraint_lower, constraint_upper) for outputs (objective, 1, 2)
BOUNDS = {
    "two_sided": ([-INF, -0.2, 0.1], [INF, 0.3, 0.9]),
    "lower_only": ([-INF, -0.1, 0.2], [INF, INF, INF]),
    "upper_only": ([-INF, -INF, -INF], [INF, 0.1, 0.5]),
    "mixed": ([-INF, -0.3, -INF], [INF, 0.2, 0.4]),
}


@jax.jit
def _j_values_and_grads(acqf, X):
    """The JAX acquisition's values and gradients at each `(1, d)` of `X`,
    compiled once per class and static configuration."""
    return jax.vmap(jax.value_and_grad(acqf))(X)


@pytest.mark.parametrize("cls", ["LogConstrainedExpectedImprovement",
                                 "ConstrainedExpectedImprovement"])
@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_constrained_analytic_matches_reference(models3, case, cls):
    """Values against the JAX package's. Its gradient is NaN wherever a
    bound is infinite (the `jnp.where` branch it does not take still sees
    `inf`), so the port's, which is finite, is held to the JAX package's
    gradient with every infinite bound replaced by +-1e30: the same
    probabilities, values within 1e-6 of the infinite bounds' (checked)."""
    (jm, jcache), (tm, tcache) = models3
    lo, hi = (np.asarray(v, np.float32) for v in BOUNDS[case])
    far = lambda b: np.where(np.isinf(b), np.sign(b) * 1e30, b).astype(np.float32)  # noqa
    X = np.random.default_rng(1).uniform(size=(8, 1, 2)).astype(np.float32)
    for maximize, index in ((True, 0), (False, 2)):
        kw = dict(best_f=0.4, maximize=maximize, objective_index=index)
        make_j = lambda a, b: getattr(ja, cls)(  # noqa: E731
            model=jm, cache=jcache, constraint_lower=jnp.asarray(a), constraint_upper=jnp.asarray(b),
            **kw)
        vj, gj = _j_values_and_grads(make_j(lo, hi), jnp.asarray(X))
        vj_far, gj_far = _j_values_and_grads(make_j(far(lo), far(hi)), jnp.asarray(X))
        assert np.isnan(np.asarray(gj)).all() and np.isfinite(np.asarray(gj_far)).all()
        np.testing.assert_allclose(np.asarray(vj_far), np.asarray(vj), rtol=1e-6, atol=1e-6)
        at = getattr(ta, cls)(model=tm, cache=tcache, constraint_lower=torch.tensor(lo),
                              constraint_upper=torch.tensor(hi), **kw)
        Xt = torch.tensor(X, requires_grad=True)
        vt = at(Xt)
        (gt,) = torch.autograd.grad(vt.sum(), Xt)
        assert vt.shape == (8,) and bool(torch.isfinite(gt).all())
        np.testing.assert_allclose(_np(vt), np.asarray(vj), rtol=3e-4, atol=1e-6)
        scale = float(np.abs(np.asarray(gj_far)).max())
        np.testing.assert_allclose(_np(gt), np.asarray(gj_far), rtol=0, atol=3e-3 * scale + 1e-7)


def test_constrained_analytic_refuses_an_ensemble():
    X = np.random.default_rng(0).uniform(size=(6, 2))
    base = tgp.make_gp(X, X.sum(-1), kernel="matern52", use_outputscale=True, device="cpu")
    ens = load_saas_samples(torch.zeros(3, 6), base)
    with pytest.raises(NotImplementedError, match="ensemble"):
        ta.LogConstrainedExpectedImprovement(model=ens, cache=ens.train_chol(),
                                             constraint_lower=torch.zeros(1),
                                             constraint_upper=torch.ones(1))


def test_constrained_problems_match_reference():
    rng = np.random.default_rng(2)
    for name, kw in (("ConstrainedGramacy", {}), ("ConstrainedHartmann", {}),
                     ("ConstrainedHartmannSmooth", {})):
        jf, tf = getattr(jx, name)(**kw), getattr(tx, name)(**kw)
        X = (rng.uniform(size=(20, tf.dim)) * (0.6 if tf.dim == 6 else 1.0)).astype(np.float32)
        for negate in (False, True):
            jf.negate = tf.negate = negate
            np.testing.assert_allclose(_np(tf(torch.tensor(X))), np.asarray(jf(jnp.asarray(X))),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(tf.evaluate_slack(torch.tensor(X))),
                                   np.asarray(jf.evaluate_slack(jnp.asarray(X))),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(tf.is_feasible(torch.tensor(X))),
                                      np.asarray(jf.is_feasible(jnp.asarray(X))))
        assert tf.num_constraints == jf.num_constraints
        assert tf.optimal_value == jf.optimal_value
    g = tx.ConstrainedGramacy()
    assert bool(g.is_feasible(g.optimizers)) and float(g(g.optimizers)) == pytest.approx(0.5998)


def test_outcome_constraint_helpers_match_reference():
    s = np.random.default_rng(3).normal(size=(7, 4, 3)).astype(np.float32)
    A = np.array([[1.0, -0.5, 0.0], [0.0, 1.0, 1.0]], np.float32)
    b = np.array([[0.2], [0.5]], np.float32)
    cj = juc.get_outcome_constraint_transforms((jnp.asarray(A), jnp.asarray(b)))
    ct = tuc.get_outcome_constraint_transforms((torch.tensor(A), torch.tensor(b)))
    assert tuc.get_outcome_constraint_transforms(None) is None
    st, sj = torch.tensor(s), jnp.asarray(s)
    for c_t, c_j in zip(ct, cj):
        np.testing.assert_allclose(_np(c_t(st)), np.asarray(c_j(sj)), atol=1e-6)
    for desc in (False, True):
        for t, j in zip(tuc.get_monotonicity_constraints(4, descending=desc),
                        juc.get_monotonicity_constraints(4, descending=desc)):
            np.testing.assert_array_equal(_np(t), np.asarray(j))
    obj_t, obj_j = st[..., 0], sj[..., 0]
    for eta in (1e-1, [1e-1, 3e-1]):
        for log in (False, True):
            np.testing.assert_allclose(
                _np(tuc.compute_smoothed_feasibility_indicator(ct, st, eta, log=log)),
                np.asarray(juc.compute_smoothed_feasibility_indicator(cj, sj, eta, log=log)),
                rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            _np(tuc.apply_constraints(obj_t, ct, st, infeasible_cost=2.0, eta=eta)),
            np.asarray(juc.apply_constraints(obj_j, cj, sj, infeasible_cost=2.0, eta=eta)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            _np(tuc.apply_constraints_nonnegative_soft(st, ct, st, eta)),
            np.asarray(juc.apply_constraints_nonnegative_soft(sj, cj, sj, eta)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(tuc.compute_feasibility_indicator(ct, st)),
                                  np.asarray(juc.compute_feasibility_indicator(cj, sj)))
    assert bool(tuc.compute_feasibility_indicator(None, st).all())
    # the MC acquisitions' feasibility weight is this module's one definition
    assert tmc.smoothed_feasibility_log_indicator is tuc.smoothed_feasibility_log_indicator


def test_estimate_feasible_volume_from_reference_uniforms(models3):
    (jm, _), (tm, _) = models3
    bounds = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    cons_j = [lambda y: y[..., 1] - 0.1]
    cons_t = [lambda y: y[..., 1] - 0.1]
    key = jax.random.PRNGKey(3)
    vj = float(jax.jit(lambda m, k: juc.estimate_feasible_volume(
        m, jnp.asarray(bounds), cons_j, k, num_points=256))(jm, key))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (256, 2))))
    vt = float(tuc.estimate_feasible_volume(tm, torch.tensor(bounds), cons_t, uniforms=u))
    assert 0.0 < vt < 1.0 and vt == pytest.approx(vj, abs=1.5 / 256)
    with pytest.raises(ValueError, match="generator"):
        tuc.estimate_feasible_volume(tm, torch.tensor(bounds), cons_t)
    own = tuc.estimate_feasible_volume(tm, torch.tensor(bounds), cons_t, make_generator(0, "cpu"),
                                       num_points=64)
    assert 0.0 <= float(own) <= 1.0


def test_noisy_fallback_is_dead_in_both_packages():
    """`_NoisyMixin` gives a sample without a feasible baseline point the
    smallest objective value as its best; but that row holds only `-inf`,
    so the smallest value is `-inf` too, and the best stays `-inf` in the
    JAX package (`monte_carlo.py:246-247`). The port does the same, and
    qLogNEI's value is then `+inf` in both."""
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(3, 2)).astype(np.float32)
    Y = np.stack([X.sum(-1), rng.normal(size=3) * 0.1], -1).astype(np.float32)
    pn = {"mean": np.zeros(2, np.float32), "raw_lengthscale": np.zeros((2, 2), np.float32),
          "raw_outputscale": np.zeros(2, np.float32),
          "raw_noise": np.log(np.array([1e-2, 1.0], np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y, device="cpu", params=convert.gp_params_from_numpy(pn))
    kw = dict(q=1, num_samples=32, constraints=(lambda s: s[..., 1],))
    at = tmc.make_mc_acqf(tmc.qLogNoisyExpectedImprovement, tm, X_baseline=torch.tensor(X), **kw)
    aj = jmc.qLogNoisyExpectedImprovement(
        model=jm, cache=jax.jit(lambda m: m.train_chol())(jm),
        base_samples=jnp.asarray(_np(at.base_samples)), X_baseline=jnp.asarray(X),
        constraints=kw["constraints"])
    x = np.array([[0.4, 0.6]], np.float32)
    best_j, val_j = jax.jit(lambda a, v: (a._joint_obj(v)[2][:, 0], a(v)))(aj, jnp.asarray(x))
    best_j, val_j = np.asarray(best_j), float(val_j)
    best_t = _np(at._joint_obj(torch.tensor(x[None]))[2])[:, 0, 0]
    none_feasible = np.isneginf(best_j)
    assert 0 < none_feasible.sum() < len(best_j)
    np.testing.assert_array_equal(np.isneginf(best_t), none_feasible)
    np.testing.assert_allclose(best_t[~none_feasible], best_j[~none_feasible], rtol=1e-4,
                               atol=1e-5)
    assert math.isinf(val_j) and val_j > 0
    assert torch.isposinf(at(torch.tensor(x[None])))


# --------------------------------------------------------------------- #
# The JAX package's LogCEI with an infinite bound has a NaN gradient (see
# `test_constrained_analytic_matches_reference`): its ascent would stop at
# the initial conditions. Its side of the Gramacy comparisons takes +-1e30
# for the infinite bounds, the same probabilities with a finite gradient.
J_GRAMACY_BOUNDS = dict(constraint_lower=jnp.asarray([-1e30, 0.0, 0.0]),
                        constraint_upper=jnp.full((3,), 1e30))


def _jax_fit(X, Y, mask, key):
    """The JAX package's fit of the loops' GP, and its fit starts."""
    model = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y), mask=jnp.asarray(mask))
    x0 = j_prepare_fit(model, key, CFG["fit_restarts"])[2]
    fit = jax.jit(lambda m, k: j_fit_gp(m, k, num_restarts=CFG["fit_restarts"],
                                        maxiter=CFG["fit_maxiter"]))
    return fit(model, key), np.asarray(x0)


def _compare_step(params_j, params_t, cand_j, val_j, cand_t, val_t):
    pt = convert.gp_params_to_numpy(params_t)
    for f in convert.GPParams.FIELDS:
        np.testing.assert_allclose(pt[f], np.asarray(getattr(params_j, f)), atol=2e-2, err_msg=f)
    np.testing.assert_allclose(_np(cand_t), np.asarray(cand_j), atol=2e-2)
    assert float(val_t) == pytest.approx(float(val_j), rel=2e-3, abs=1e-3)


def test_gramacy_step_matches_reference():
    n, cap = 12, 30
    sv, shift = j_sobol_table(2, scramble=True, seed=1)
    X = np.zeros((cap, 2), np.float32)
    X[:n] = np.asarray(j_draw_sobol(sv, shift, n))
    jf = jx.ConstrainedGramacy(negate=True)
    Y = np.zeros((cap, 3), np.float32)
    Y[:n] = np.concatenate([np.asarray(jf(jnp.asarray(X[:n])))[:, None],
                            np.asarray(jf.evaluate_slack(jnp.asarray(X[:n])))], -1)
    mask = np.arange(cap) < n
    model_j, x0 = _jax_fit(X, Y, mask, jax.random.PRNGKey(2))
    feasible = mask & (Y[:, 1:] >= 0).all(-1)
    assert feasible.any()
    acq_j = ja.LogConstrainedExpectedImprovement(
        model=model_j, cache=jax.jit(lambda m: m.train_chol())(model_j),
        best_f=float(Y[feasible, 0].max()), **J_GRAMACY_BOUNDS)
    ics = np.random.default_rng(6).uniform(size=(CFG["num_restarts"], 1, 2)).astype(np.float32)
    cand_j, val_j = j_optimize_acqf(acq_j, jnp.stack([jnp.zeros(2), jnp.ones(2)]), q=1,
                                    maxiter=CFG["acq_maxiter"], initial_conditions=jnp.asarray(ics))
    cand_t, val_t, params_t = cs.gramacy_step(
        torch.tensor(X), torch.tensor(Y), n, None, make_generator(0, "cpu"), fit_x0=x0,
        initial_conditions=ics)
    _compare_step(model_j.params, params_t, cand_j, val_j, cand_t, val_t)
    np.testing.assert_allclose(_np(cs.gramacy_evaluate(cand_t)),
                               np.concatenate([np.asarray(jf(jnp.asarray(_np(cand_t))))[:, None],
                                               np.asarray(jf.evaluate_slack(
                                                   jnp.asarray(_np(cand_t))))], -1), atol=1e-6)


def test_hartmann_linear_step_matches_reference():
    n, cap = 12, 22
    X = np.zeros((cap, 6), np.float32)
    X[:n] = np.random.default_rng(7).uniform(size=(n, 6)) * 0.5  # sum(x) <= 3
    jh = JHartmann(dim=6, negate=True)
    Y = np.zeros(cap, np.float32)
    Y[:n] = np.asarray(jh(jnp.asarray(X[:n])))
    mask = np.arange(cap) < n
    model_j, x0 = _jax_fit(X, Y[:, None], mask, jax.random.PRNGKey(3))
    acq_j = ja.LogExpectedImprovement(model=model_j,
                                      cache=jax.jit(lambda m: m.train_chol())(model_j),
                                      best_f=float(Y[:n].max()))
    ics = (np.random.default_rng(8).uniform(size=(CFG["num_restarts"], 1, 6)) * 0.5
           ).astype(np.float32)
    cand_j, val_j = j_optimize_acqf(acq_j, jnp.stack([jnp.zeros(6), jnp.ones(6)]), q=1,
                                    maxiter=CFG["acq_maxiter"], initial_conditions=jnp.asarray(ics),
                                    inequality_constraints=cs.HARTMANN_SUM_LE_3)
    cand_t, val_t, params_t = cs.hartmann_linear_step(
        torch.tensor(X), torch.tensor(Y), n, make_generator(0, "cpu"), fit_x0=x0,
        initial_conditions=ics)
    _compare_step(model_j.params, params_t, cand_j, val_j, cand_t, val_t)
    assert float(cand_t.sum()) <= 3.0 + 1e-5 and float(jnp.sum(cand_j)) <= 3.0 + 1e-5


def test_constrained_loops_run_small():
    X, Y = cs.gramacy_loop(seed=1, n_init=6, iterations=2, device="cpu",
                           cfg=dict(CFG, num_restarts=2, raw_samples=8, fit_maxiter=5,
                                    acq_maxiter=5))
    assert X.shape == (8, 2) and Y.shape == (8, 3) and bool(torch.isfinite(Y).all())
    torch.testing.assert_close(Y, cs.gramacy_evaluate(X))
    X, Y = cs.hartmann_linear_loop(seed=1, n_init=6, iterations=2, device="cpu",
                                   cfg=dict(CFG, num_restarts=2, raw_samples=8, fit_maxiter=5,
                                            acq_maxiter=5))
    assert X.shape == (8, 6) and bool(torch.isfinite(Y).all())
    assert float(X.sum(-1).max()) <= 3.0 + 1e-5 and bool(((X >= 0) & (X <= 1)).all())


# --------------------------------------------------------------------- #
def _jax_gramacy_loop(seed: int, n_init: int = 10, iterations: int = 20):
    """The JAX package's ConstrainedGramacy loop, as `chip_smoke.gramacy_loop`
    builds the port's: Sobol design, 3-output fit warm-started from the last
    iteration, LogCEI, the box-only `optimize_acqf` on the loop's Sobol
    stream."""
    prob = jx.ConstrainedGramacy(negate=True)
    evaluate = lambda X: jnp.concatenate([prob(X)[:, None], prob.evaluate_slack(X)], -1)  # noqa
    cap = n_init + iterations
    sobol = j_sobol_table(2, scramble=True, seed=seed)
    X = jnp.zeros((cap, 2)).at[:n_init].set(j_draw_sobol(*sobol, n_init))
    Y = jnp.zeros((cap, 3)).at[:n_init].set(evaluate(X[:n_init]))

    @jax.jit
    def step(X, Y, n, key, params0):
        mask = jnp.arange(cap) < n
        k_fit, k_acq = jax.random.split(key)
        model = jgp.make_gp(X, Y, mask=mask)
        if params0 is not None:
            model = model.replace(params=params0, _cache=None)
        model = j_fit_gp(model, k_fit, num_restarts=CFG["fit_restarts"],
                         maxiter=CFG["fit_maxiter"])
        feasible = mask & jnp.all(Y[:, 1:] >= 0, axis=-1)
        best_f = jnp.max(jnp.where(feasible, Y[:, 0], -jnp.inf))
        best_f = jnp.where(jnp.isfinite(best_f), best_f,
                           jnp.min(jnp.where(mask, Y[:, 0], jnp.inf)))
        acqf = ja.LogConstrainedExpectedImprovement(
            model=model, cache=model.train_chol(), best_f=best_f,
            **J_GRAMACY_BOUNDS)
        cand, _ = j_optimize_acqf(acqf, jnp.stack([jnp.zeros(2), jnp.ones(2)]), q=1,
                                  num_restarts=CFG["num_restarts"],
                                  raw_samples=CFG["raw_samples"], key=k_acq,
                                  maxiter=CFG["acq_maxiter"], sobol=sobol,
                                  sobol_skip=(n.astype(jnp.uint32) + 1)
                                  * jnp.uint32(CFG["raw_samples"]))
        return cand, model.params

    key = jax.random.PRNGKey(seed)
    params = None
    for i in range(iterations):
        n = n_init + i
        key, k = jax.random.split(key)
        cand, params = step(X, Y, jnp.int32(n), k, params)
        X = X.at[n].set(cand[0])
        Y = Y.at[n].set(evaluate(cand)[0])
    return np.asarray(X), np.asarray(Y)


def _jax_hartmann_linear_loop(seed: int, n_init: int = 10, iterations: int = 12):
    """The JAX package's Hartmann-6 loop under sum(x) <= 3, as
    `chip_smoke.hartmann_linear_loop` builds the port's."""
    prob = JHartmann(dim=6, negate=True)
    cap = n_init + iterations
    bounds = jnp.stack([jnp.zeros(6), jnp.ones(6)])
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    X = jnp.zeros((cap, 6)).at[:n_init].set(
        j_polytope(k0, n_init, bounds, inequality_constraints=cs.HARTMANN_SUM_LE_3))
    Y = jnp.zeros((cap,)).at[:n_init].set(prob(X[:n_init]))

    @jax.jit
    def fit(X, Y, n, key, params0):
        mask = jnp.arange(cap) < n
        model = jgp.make_gp(X, Y[:, None], mask=mask)
        if params0 is not None:
            model = model.replace(params=params0, _cache=None)
        model = j_fit_gp(model, key, num_restarts=CFG["fit_restarts"],
                         maxiter=CFG["fit_maxiter"])
        return ja.LogExpectedImprovement(model=model, cache=model.train_chol(),
                                         best_f=jnp.max(jnp.where(mask, Y, -jnp.inf)))

    params = None
    for i in range(iterations):
        n = n_init + i
        key, k_fit, k_acq = jax.random.split(key, 3)
        acqf = fit(X, Y, jnp.int32(n), k_fit, params)
        params = acqf.model.params
        cand, _ = j_optimize_acqf(acqf, bounds, q=1, num_restarts=CFG["num_restarts"],
                                  raw_samples=CFG["raw_samples"], key=k_acq,
                                  maxiter=CFG["acq_maxiter"],
                                  inequality_constraints=cs.HARTMANN_SUM_LE_3)
        X = X.at[n].set(cand[0])
        Y = Y.at[n].set(prob(cand)[0])
    return np.asarray(X), np.asarray(Y)


def _gramacy_gain(Y, n_init: int = 10) -> float:
    """Best feasible objective over the run less the design's (the design's
    is the box's lowest objective, -2, where none of it is feasible)."""
    feasible = (Y[:, 1:] >= 0).all(-1)
    best = lambda rows: max([-2.0] + [float(v) for v in Y[rows & feasible, 0]])  # noqa: E731
    design = np.arange(len(Y)) < n_init
    return best(np.ones(len(Y), bool)) - best(design)


SEEDS = range(8)


@pytest.mark.slow
def test_gramacy_loop_over_seeds_matches_reference():
    gains_t, gains_j = [], []
    for seed in SEEDS:
        X, Y = cs.gramacy_loop(seed=seed, device="cpu", **cs.GRAMACY_LOOP)
        gains_t.append(_gramacy_gain(_np(Y)))
        gains_j.append(_gramacy_gain(_jax_gramacy_loop(seed, **cs.GRAMACY_LOOP)[1]))
    mean_t, mean_j, sd_j = np.mean(gains_t), np.mean(gains_j), np.std(gains_j)
    print(f"Gramacy gain over 8 seeds: port {mean_t:.4f} {gains_t}, "
          f"reference {mean_j:.4f} (sd {sd_j:.4f}) {gains_j}")
    assert mean_t >= mean_j - 0.5 * sd_j, (gains_t, gains_j)


@pytest.mark.slow
def test_hartmann_linear_loop_over_seeds_matches_reference():
    gains_t, gains_j = [], []
    n0 = cs.HARTMANN_LOOP["n_init"]
    for seed in SEEDS:
        X, Y = cs.hartmann_linear_loop(seed=seed, device="cpu", **cs.HARTMANN_LOOP)
        assert float(X.sum(-1).max()) <= 3.0 + 1e-5
        Y = _np(Y)
        gains_t.append(float(Y.max() - Y[:n0].max()))
        Yj = _jax_hartmann_linear_loop(seed, **cs.HARTMANN_LOOP)[1]
        gains_j.append(float(Yj.max() - Yj[:n0].max()))
    mean_t, mean_j, sd_j = np.mean(gains_t), np.mean(gains_j), np.std(gains_j)
    print(f"Hartmann-6 sum(x) <= 3 gain over 8 seeds: port {mean_t:.4f} {gains_t}, "
          f"reference {mean_j:.4f} (sd {sd_j:.4f}) {gains_j}")
    assert mean_t >= mean_j - 0.5 * sd_j, (gains_t, gains_j)
