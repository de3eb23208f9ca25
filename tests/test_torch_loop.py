"""Port parity for `loop.py`, the slice as a whole, against botorch_tpu.

* The Sobol initial design is bit-for-bit the reference's.
* One `_bo_step` on a 12-point Branin history at the BO loop's budgets
  (6 restarts, 64 raw samples, 2 fit restarts, 15 fit and 15 ascent
  iterations), with the reference's fit starts and initial conditions
  fed in: fitted raw hyperparameters within 2e-2, acquisition value
  within rtol 2e-3, candidate within 2e-2. Both run float32 L-BFGS with
  15-step budgets, which stop short of convergence, so the last digits
  of the rounding decide where a lane stops along a flat direction.
* One qLogNEI `_bo_step` (q = 2, 32 qMC samples) on a 12-point Hartmann-3
  history in a 16-row buffer, with the reference's fit starts, base
  samples and initial conditions fed in: fitted raw hyperparameters,
  candidates and the acquisition value within 5e-3. The 15-step float32
  ascents stop short of convergence, but this surface is steep enough
  that the two packages' rounding moves a lane by ~1e-4 only.
* A 2-iteration qLogNEI loop on the CPU.
* The 8-seed Branin regret at `bench.py`'s budgets, and the 8-seed
  Hartmann-6 qLogNEI regret of config 2 (both marked slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu import loop as jloop
from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.acquisition.analytic import LogExpectedImprovement as JLogEI
from botorch_tpu.fit import _prepare_fit as j_prepare_fit
from botorch_tpu.fit import fit_gp as j_fit_gp
from botorch_tpu.models.gp import make_gp as j_make_gp
from botorch_tpu.optim.optimize import gen_batch_initial_conditions as j_gen_ics
from botorch_tpu.sampling.sobol import sobol_table as j_sobol_table
from botorch_tpu.test_functions.synthetic import Branin as JBranin
from botorch_tpu.test_functions.synthetic import Hartmann as JHartmann
from botorch_tpu.utils.transforms import unnormalize as j_unnormalize
from botorch_tpu_torch import convert
from botorch_tpu_torch import loop as tloop
from botorch_tpu_torch.sampling.sobol import sobol_table as t_sobol_table
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.test_functions.synthetic import Branin, Hartmann
from botorch_tpu_torch.utils.transforms import unnormalize
from _torch_threads import _one_torch_thread  # noqa: F401


CFG = dict(num_restarts=6, raw_samples=64, fit_restarts=2, fit_maxiter=15, acq_maxiter=15)
BRANIN_OPT = 0.397887
HARTMANN6_OPT = 3.32237


def _branin_t():
    prob = Branin(negate=True)
    return lambda X: prob(unnormalize(X, prob.bounds))


def test_init_state_is_the_reference_design():
    st_t, X0_t = tloop.init_state(10, 2, 35, seed=0, device="cpu")
    st_j, X0_j = jloop.init_state(10, 2, 35, seed=0)
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    np.testing.assert_array_equal(st_t.X.numpy(), np.asarray(st_j.X))
    st_t = tloop.append_observations(st_t, X0_t, _branin_t()(X0_t))
    assert st_t.n == 10 and st_t.Y[:10].abs().sum() > 0 and st_t.Y[10:].abs().sum() == 0
    with pytest.raises(ValueError):
        tloop.append_observations(st_t, torch.zeros(26, 2), torch.zeros(26))


def test_test_functions_match_reference():
    X = np.random.default_rng(0).uniform(size=(20, 2)).astype(np.float32)
    jb = JBranin(negate=True)
    np.testing.assert_allclose(
        _branin_t()(torch.tensor(X)).numpy(),
        np.asarray(jb(j_unnormalize(jnp.asarray(X), jb.bounds))), rtol=1e-6, atol=1e-5)
    from botorch_tpu.test_functions.synthetic import Hartmann as JHartmann

    for d in (3, 4, 6):
        Xh = np.random.default_rng(d).uniform(size=(16, d)).astype(np.float32)
        np.testing.assert_allclose(Hartmann(dim=d)(torch.tensor(Xh)).numpy(),
                                   np.asarray(JHartmann(dim=d)(jnp.asarray(Xh))), rtol=1e-5)
        opt = Hartmann(dim=d).optimizers
        assert float(Hartmann(dim=d)(opt)[0]) == pytest.approx(Hartmann(dim=d).optimal_value,
                                                              abs=1e-4)
    b = Branin()
    np.testing.assert_allclose(b(b.optimizers).numpy(), BRANIN_OPT, atol=1e-5)


@pytest.fixture(scope="module")
def history():
    """A 12-point Branin history in a 20-row buffer (both packages)."""
    st_j, X0 = jloop.init_state(12, 2, 20, seed=3)
    jb = JBranin(negate=True)
    st_j = jloop.append_observations(st_j, X0, jb(j_unnormalize(X0, jb.bounds)))
    st_t = tloop.BOState(X=torch.tensor(np.asarray(st_j.X)), Y=torch.tensor(np.asarray(st_j.Y)),
                         n=int(st_j.n))
    return st_j, st_t


def test_bo_step_against_reference(history):
    st_j, st_t = history
    key = jax.random.PRNGKey(11)
    sob_j = j_sobol_table(2, scramble=True, seed=3)
    cand_j, val_j, params_j = jloop._bo_step(st_j, key, sob_j, **CFG)
    # the reference's random draws inside that step, re-derived from its key
    k_fit, k_acq, _ = jax.random.split(key, 3)
    mask = jnp.arange(20) < st_j.n
    model_j = j_make_gp(st_j.X, st_j.Y[:, None], mask=mask)
    _, _, x0_j, _, _ = j_prepare_fit(model_j, k_fit, CFG["fit_restarts"])
    fitted_j = j_fit_gp(model_j, k_fit, num_restarts=CFG["fit_restarts"],
                        maxiter=CFG["fit_maxiter"])
    acq_j = JLogEI(model=fitted_j, cache=fitted_j.train_chol(),
                   best_f=jnp.max(jnp.where(mask, st_j.Y, -jnp.inf)))
    skip = (st_j.n.astype(jnp.uint32) + 1) * jnp.uint32(CFG["raw_samples"])
    ics_j = j_gen_ics(acq_j, jnp.stack([jnp.zeros(2), jnp.ones(2)]), 1, CFG["num_restarts"],
                      CFG["raw_samples"], k_acq, sobol=sob_j, sobol_skip=skip)

    sob_t = t_sobol_table(2, scramble=True, seed=3)
    cand_t, val_t, params_t = tloop._bo_step(
        st_t, sob_t, make_generator(0, "cpu"), fit_x0=np.array(x0_j),
        initial_conditions=np.array(ics_j), **CFG)
    pj = {f: np.asarray(getattr(params_j, f)) for f in convert.GPParams.FIELDS}
    pt = convert.gp_params_to_numpy(params_t)
    for f in pj:
        np.testing.assert_allclose(pt[f], pj[f], atol=2e-2, err_msg=f)
    assert cand_t.shape == (1, 2)
    assert float(val_t) == pytest.approx(float(val_j), rel=2e-3, abs=1e-3)
    np.testing.assert_allclose(cand_t.numpy(), np.asarray(cand_j), atol=2e-2)


def test_public_bo_step_is_the_step(history):
    _, st_t = history
    sob = t_sobol_table(2, seed=3)
    small = dict(num_restarts=3, raw_samples=16, fit_restarts=2, fit_maxiter=5, acq_maxiter=5)
    cand, val = tloop.bo_step(st_t, sob, make_generator(4, "cpu"), device="cpu", **small)
    cand2, val2, _ = tloop._bo_step(st_t, sob, make_generator(4, "cpu"), **small)
    assert torch.equal(cand, cand2) and torch.equal(val, val2)
    cand, val = tloop.bo_step(st_t, sob, make_generator(4, "cpu"), acqf_name="qLogNEI",
                              mc_samples=16, device="cpu", **small)
    cand2, val2, _ = tloop._bo_step(st_t, sob, make_generator(4, "cpu"), acqf_name="qLogNEI",
                                    mc_samples=16, **small)
    assert torch.equal(cand, cand2) and torch.equal(val, val2)
    with pytest.raises(NotImplementedError):
        tloop.bo_step(st_t, sob, acqf_name="qKG", device="cpu")


@pytest.mark.parametrize("acqf_name", ["EI", "UCB"])
def test_run_bo_loop_small(acqf_name):
    st = tloop.run_bo_loop(_branin_t(), d=2, n_init=5, iterations=2, seed=1, device="cpu",
                           acqf_name=acqf_name, num_restarts=3, raw_samples=16,
                           fit_restarts=2, fit_maxiter=5, acq_maxiter=5)
    assert st.n == 7 and st.X.shape == (7, 2) and st.X.device.type == "cpu"
    assert torch.isfinite(st.Y).all() and torch.all((st.X >= 0) & (st.X <= 1))
    assert float(tloop.best_observed(st)) == pytest.approx(float(st.Y.max()))


MC_CFG = dict(num_restarts=4, raw_samples=32, fit_restarts=2, fit_maxiter=15, acq_maxiter=15)


def test_qlognei_bo_step_against_reference():
    cap, d, q, nmc = 16, 3, 2, 32
    st_j, X0 = jloop.init_state(12, d, cap, seed=3)
    st_j = jloop.append_observations(st_j, X0, JHartmann(dim=d, negate=True)(X0))
    sob_j = j_sobol_table(q * d, scramble=True, seed=3)

    @jax.jit
    def reference(state, key):
        """The reference's step, and the random draws inside it re-derived
        from its key: the fit's restart starts, the base samples and the
        initial conditions."""
        cand, val, params = jloop._bo_step(state, key, sob_j, acqf_name="qLogNEI", q=q,
                                           mc_samples=nmc, **MC_CFG)
        k_fit, k_acq, k_base = jax.random.split(key, 3)
        mask = jnp.arange(cap) < state.n
        model = j_make_gp(state.X, state.Y[:, None], mask=mask)
        _, _, x0, _, _ = j_prepare_fit(model, k_fit, MC_CFG["fit_restarts"])
        fitted = model.replace(params=params, _cache=None)
        base = jmc.draw_fresh_base_samples(cap + q, 1, nmc, k_base, seed=17)
        acq = jmc.qLogNoisyExpectedImprovement(
            model=fitted, cache=fitted.train_chol(), base_samples=base,
            X_baseline=state.X, baseline_mask=mask)
        skip = (state.n.astype(jnp.uint32) + 1) * jnp.uint32(MC_CFG["raw_samples"])
        ics = j_gen_ics(acq, jnp.stack([jnp.zeros(d), jnp.ones(d)]), q, MC_CFG["num_restarts"],
                        MC_CFG["raw_samples"], k_acq, sobol=sob_j, sobol_skip=skip)
        return cand, val, params, x0, base, ics

    cand_j, val_j, params_j, x0_j, base_j, ics_j = reference(st_j, jax.random.PRNGKey(11))
    st_t = tloop.BOState(X=torch.tensor(np.asarray(st_j.X)), Y=torch.tensor(np.asarray(st_j.Y)),
                         n=int(st_j.n))
    cand_t, val_t, params_t = tloop._bo_step(
        st_t, t_sobol_table(q * d, scramble=True, seed=3), make_generator(0, "cpu"),
        acqf_name="qLogNEI", q=q, mc_samples=nmc, fit_x0=np.array(x0_j),
        initial_conditions=np.array(ics_j), base_samples=np.array(base_j), **MC_CFG)
    pt = convert.gp_params_to_numpy(params_t)
    for f in convert.GPParams.FIELDS:
        np.testing.assert_allclose(pt[f], np.asarray(getattr(params_j, f)), atol=5e-3, err_msg=f)
    assert cand_t.shape == (q, d)
    np.testing.assert_allclose(cand_t.numpy(), np.asarray(cand_j), atol=5e-3)
    assert float(val_t) == pytest.approx(float(val_j), rel=5e-3, abs=5e-3)


def test_run_qlognei_loop_small():
    prob = Hartmann(dim=3, negate=True)
    st = tloop.run_bo_loop(prob, d=3, n_init=6, iterations=2, seed=2, q=2, device="cpu",
                           acqf_name="qLogNEI", mc_samples=16, **MC_CFG)
    assert st.n == 10 and st.X.shape == (10, 3)
    assert torch.isfinite(st.Y).all() and torch.all((st.X >= 0) & (st.X <= 1))


@pytest.mark.slow
def test_hartmann6_qlognei_regret_over_seeds_matches_reference():
    """Config 2 (`bench.py:104-125`: Hartmann-6, q = 4, 16 initial points,
    15 iterations, 128 qMC samples) over 8 seeds in both packages: the
    port's mean regret is at most the reference's + 0.1."""
    cfg = dict(num_restarts=6, raw_samples=64, fit_restarts=2, fit_maxiter=15, acq_maxiter=15,
               acqf_name="qLogNEI", mc_samples=128)
    jh = JHartmann(dim=6, negate=True)
    regrets_t, regrets_j = [], []
    for seed in range(8):
        st = tloop.run_bo_loop(Hartmann(dim=6, negate=True), d=6, n_init=16, iterations=15,
                               seed=seed, q=4, device="cpu", **cfg)
        regrets_t.append(HARTMANN6_OPT - float(tloop.best_observed(st)))
        st_j = jloop.run_bo_loop(jh, d=6, n_init=16, iterations=15, key=jax.random.PRNGKey(seed),
                                 seed=seed, q=4, **cfg)
        regrets_j.append(HARTMANN6_OPT - float(jloop.best_observed(st_j)))
    mean_t, mean_j = float(np.mean(regrets_t)), float(np.mean(regrets_j))
    print(f"config-2 regret over 8 seeds: port {mean_t:.4f} {regrets_t}, "
          f"reference {mean_j:.4f} {regrets_j}")
    assert mean_t <= mean_j + 0.1, (regrets_t, regrets_j)


@pytest.mark.slow
def test_branin_regret_over_seeds_matches_reference():
    """8 seeds at bench.py's budgets: the port's regret distribution stays
    with the reference's (mean 0.0068 and max 0.0206 over 16 seeds in
    bench.py's own study)."""
    jb = JBranin(negate=True)
    obj_j = lambda X: jb(j_unnormalize(X, jb.bounds))  # noqa: E731
    regrets_t, regrets_j = [], []
    for seed in range(8):
        st = tloop.run_bo_loop(_branin_t(), d=2, n_init=10, iterations=25, seed=seed,
                               device="cpu", **CFG)
        regrets_t.append(-float(tloop.best_observed(st)) - BRANIN_OPT)
        st_j = jloop.run_bo_loop(obj_j, d=2, n_init=10, iterations=25,
                                 key=jax.random.PRNGKey(seed), seed=seed, **CFG)
        regrets_j.append(-float(jloop.best_observed(st_j)) - BRANIN_OPT)
    mean_t, mean_j = float(np.mean(regrets_t)), float(np.mean(regrets_j))
    assert max(regrets_t) < 0.5
    assert mean_t < max(2.0 * mean_j, 0.02), (regrets_t, regrets_j)
