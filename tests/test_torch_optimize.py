"""Port parity for `optim/optimize.py` (unconstrained path) against
botorch_tpu: the Sobol raw candidates are bit-for-bit the reference's, and
`optimize_acqf` from the same initial conditions reaches the same
converged candidates (atol 1e-3) and values (rtol 1e-3; see
test_torch_analytic.py for the acquisition's own float32 error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import analytic as ja
from botorch_tpu.models import gp as jgp
from botorch_tpu.optim import optimize as jo
from botorch_tpu.sampling.sobol import sobol_table as j_sobol_table
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import analytic as ta
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.optim import optimize as to
from botorch_tpu_torch.sampling.sobol import sobol_table as t_sobol_table
from botorch_tpu_torch.settings import make_generator
from _torch_threads import _one_torch_thread  # noqa: F401


def _acqfs(dtype=np.float32):
    """The same LogEI acquisition in both packages (build the JAX one under
    `jax.enable_x64` for float64)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(12, 2)).astype(dtype)
    Y = -((X[:, 0] - 0.3) ** 2 + (X[:, 1] - 0.7) ** 2).astype(dtype)
    pn = {"mean": np.array([0.0], dtype),
          "raw_lengthscale": np.log(np.array([[0.25, 0.35]], dtype)),
          "raw_outputscale": np.zeros(1, dtype),
          "raw_noise": np.log(np.array([1e-2], dtype))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None], dtype=dtype,
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tm = tgp.make_gp(X, Y[:, None], device="cpu", dtype=tdt,
                     params=convert.gp_params_from_numpy(pn, dtype=tdt))
    best = float(Y.max())
    return (ja.make_acqf("LogEI", jm, best_f=best), ta.make_acqf("LogEI", tm, best_f=best))


@pytest.fixture(scope="module")
def acqfs():
    return _acqfs()


def test_initialize_q_batch_keeps_argmax_and_finite():
    X = torch.rand(64, 1, 2, generator=torch.Generator().manual_seed(0))
    vals = torch.randn(64, generator=torch.Generator().manual_seed(1))
    vals[5] = 100.0
    vals[7] = torch.nan
    vals[9] = -torch.inf
    for seed in range(5):
        ics = to.initialize_q_batch(make_generator(seed, "cpu"), X, vals, 6)
        assert ics.shape == (6, 1, 2)
        picked = {int(torch.nonzero((X == ic).all(-1).all(-1))[0]) for ic in ics}
        assert 5 in picked and 7 not in picked and 9 not in picked and len(picked) == 6
    a = to.initialize_q_batch(make_generator(3, "cpu"), X, vals, 6)
    b = to.initialize_q_batch(make_generator(3, "cpu"), X, vals, 6)
    assert torch.equal(a, b)


def test_raw_candidates_are_the_reference_sobol_points():
    """With every raw candidate selected, both packages return the same
    set of Sobol points (the Boltzmann draw only permutes them)."""
    bounds = np.array([[0.0, -1.0], [1.0, 2.0]], np.float32)
    sv_t, sh_t = t_sobol_table(2, seed=4)
    sv_j, sh_j = j_sobol_table(2, seed=4)
    raw_t = to.gen_batch_initial_conditions(
        lambda X: X.sum((-1, -2)), torch.tensor(bounds), 1, 32, 32,
        make_generator(0, "cpu"), sobol=(sv_t, sh_t), sobol_skip=96).numpy()
    raw_j = np.asarray(jo.gen_batch_initial_conditions(
        lambda X: jnp.sum(X), jnp.asarray(bounds), 1, 32, 32, jax.random.PRNGKey(0),
        sobol=(sv_j, sh_j), sobol_skip=96))
    key = lambda a: np.lexsort(a.reshape(len(a), -1).T)  # noqa: E731
    np.testing.assert_array_equal(raw_t[key(raw_t)], raw_j[key(raw_j)])


def test_sample_around_best():
    bounds = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])
    best = torch.tensor([[0.5, 1.0, 0.99]])
    pts = to.sample_around_best(make_generator(0, "cpu"), best, bounds, 400)
    assert pts.shape == (400, 3)
    assert torch.all(pts >= bounds[0]) and torch.all(pts <= bounds[1])
    dev = (pts - best) / (0.1 * (bounds[1] - bounds[0]))
    assert float(dev[:200].abs().max()) <= 2.0 + 1e-5  # truncated at 2 sd
    assert float(dev[:200, 0].std()) == pytest.approx(0.88, abs=0.12)  # sd of N trunc. +-2


@pytest.mark.parametrize("dtype,maxiter", [(np.float32, 40)])
def test_optimize_acqf_from_reference_initial_conditions(dtype, maxiter):
    """40 float32 steps, where every lane has converged and rounding no
    longer decides where a lane stops. (A lane-by-lane comparison of
    unconverged ascents would need float64, but the reference's kernel
    matrix accumulates in float32 even under x64; `test_torch_lbfgs.py`
    holds the solver itself lane by lane in float64.)"""
    with jax.enable_x64(dtype == np.float64):
        acq_j, acq_t = _acqfs(dtype)
        bounds = np.array([[0.0, 0.0], [1.0, 1.0]], dtype)
        ics = np.random.default_rng(5).uniform(size=(6, 1, 2)).astype(dtype)
        cj, vj = jo.optimize_acqf(acq_j, jnp.asarray(bounds), q=1, maxiter=maxiter,
                                  initial_conditions=jnp.asarray(ics), return_full=True)
        cj, vj = np.asarray(cj), np.asarray(vj)
    ct, vt = to.optimize_acqf(acq_t, bounds, q=1, maxiter=maxiter, initial_conditions=ics,
                              return_full=True, device="cpu")
    assert ct.shape == (6, 1, 2) and vt.shape == (6,) and ct.dtype == torch.from_numpy(ics).dtype
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == np.float64 else dict(atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(ct.numpy(), cj, atol=tol["atol"])
    np.testing.assert_allclose(vt.numpy(), vj, **tol)
    best_t, val_t = to.optimize_acqf(acq_t, bounds, q=1, maxiter=maxiter,
                                     initial_conditions=ics, device="cpu")
    assert float(val_t) == pytest.approx(float(vt.max()))


def test_optimize_acqf_own_initial_conditions(acqfs):
    _, acq_t = acqfs
    cand, val = to.optimize_acqf(acq_t, [[0.0, 0.0], [1.0, 1.0]], q=1, num_restarts=4,
                                 raw_samples=32, maxiter=20, seed=3, device="cpu")
    assert cand.shape == (1, 2) and torch.isfinite(val)
    assert torch.all(cand >= 0) and torch.all(cand <= 1)


# ---------------------------------------------------------------------------
# q = 4, d = 6: the joint candidate sets of config 2 (qLogNEI on Hartmann-6)


def test_raw_q_batches_at_q4_are_the_reference_sobol_points():
    """A q-batch is one point of a Sobol stream over q * d = 24 dims,
    reshaped to (q, d): the same sets of whole q-batches in both packages."""
    q, d = 4, 6
    bounds = np.stack([np.zeros(d), np.ones(d)]).astype(np.float32)
    sv_t, sh_t = t_sobol_table(q * d, seed=0)
    sv_j, sh_j = j_sobol_table(q * d, seed=0)
    raw_t = to.gen_batch_initial_conditions(
        lambda X: X.sum((-1, -2)), torch.tensor(bounds), q, 64, 64, make_generator(0, "cpu"),
        sobol=(sv_t, sh_t), sobol_skip=17 * 64).numpy()
    raw_j = np.asarray(jo.gen_batch_initial_conditions(
        lambda X: jnp.sum(X), jnp.asarray(bounds), q, 64, 64, jax.random.PRNGKey(0),
        sobol=(sv_j, sh_j), sobol_skip=17 * 64))
    assert raw_t.shape == (64, q, d)
    key = lambda a: np.lexsort(a.reshape(len(a), -1).T)  # noqa: E731
    np.testing.assert_array_equal(raw_t[key(raw_t)], raw_j[key(raw_j)])


def test_boltzmann_selection_of_q_batches_matches_reference():
    """With a large `eta` the Gumbel noise no longer matters and both
    packages select the top q-batches by value, whole and in full."""
    X = np.random.default_rng(3).uniform(size=(64, 4, 6)).astype(np.float32)
    vals = np.random.default_rng(4).permutation(64).astype(np.float32)
    got = to.initialize_q_batch(make_generator(0, "cpu"), torch.tensor(X), torch.tensor(vals), 6,
                                eta=1e4).numpy()
    ref = np.asarray(jo.initialize_q_batch(jax.random.PRNGKey(0), jnp.asarray(X),
                                           jnp.asarray(vals), 6, eta=1e4))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, X[np.argsort(-vals)[:6]])


def test_q4_lbfgs_lanes_match_reference():
    """`(num_restarts, q * d)` lanes of one qLogNEI surface (q = 4, d = 6,
    64 qMC samples) from the same initial conditions, with the loop's 15
    ascent iterations: values within 1e-3 relative (the acquisition's own
    float32 error is ~1e-4, see test_torch_mc_acquisition.py), candidates
    within 1e-2. The joint surface of four points has nearly flat
    directions, along which rounding moves an unconverged lane: 5.4e-3 at
    most here, while the values still agree to 1.5e-4.)"""
    from botorch_tpu.acquisition import monte_carlo as jmc
    from botorch_tpu_torch.acquisition import monte_carlo as tmc

    q, d, n = 4, 6, 14
    rng = np.random.default_rng(6)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    Y = (-np.sum((X - 0.4) ** 2, -1)).astype(np.float32)
    pn = {"mean": np.array([0.0], np.float32),
          "raw_lengthscale": np.log(np.full((1, d), 0.6, np.float32)),
          "raw_outputscale": np.zeros(1, np.float32),
          "raw_noise": np.log(np.array([1e-3], np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None],
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y[:, None], device="cpu", params=convert.gp_params_from_numpy(pn))
    base = np.asarray(jmc._draw_base_samples(n + q, 1, 64, 2))
    aj = jmc.qLogNoisyExpectedImprovement(model=jm, cache=jm.train_chol(),
                                          base_samples=jnp.asarray(base), X_baseline=jnp.asarray(X))
    at = tmc.qLogNoisyExpectedImprovement(model=tm, cache=tm.train_chol(),
                                          base_samples=torch.tensor(base), X_baseline=torch.tensor(X))
    bounds = np.stack([np.zeros(d), np.ones(d)]).astype(np.float32)
    ics = rng.uniform(size=(6, q, d)).astype(np.float32)
    cj, vj = jax.jit(lambda b, x0: jo.optimize_acqf(aj, b, q=q, maxiter=15, initial_conditions=x0,
                                                    return_full=True))(
        jnp.asarray(bounds), jnp.asarray(ics))
    ct, vt = to.optimize_acqf(at, bounds, q=q, maxiter=15, initial_conditions=ics,
                              return_full=True, device="cpu")
    assert ct.shape == (6, q, d) and vt.shape == (6,)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-2)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-3, atol=1e-6)
