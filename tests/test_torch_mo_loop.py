"""Port parity for `mo_loop.py`, the m = 2 qLogNEHVI loop (config 4), against
botorch_tpu on the CPU.

* The Sobol initial design is bit-for-bit the reference's, and the
  observed hypervolume agrees within 1e-6 relative.
* One sequential-greedy `_mo_bo_step` (q = 2) on a 8-point history in a
  12-row buffer at tiny budgets, with the reference's fit starts, base
  samples and initial conditions of each pick fed in: fitted raw
  hyperparameters within 5e-3 and each pick within 5e-3, as
  `test_torch_loop.py` holds the qLogNEI step (float32 L-BFGS with
  8-step budgets). Where a pick moves because the rounding of the two
  packages stops a lane elsewhere, the port's acquisition (held to the
  reference's in `test_torch_multi_objective.py`) at the reference's pick
  is within 1e-3 of its value at the port's.
* A 2-iteration loop on the CPU, and the public step.
* Config 4 over seeds 1-8 in both packages (marked slow).
The JAX side is compiled once per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu import mo_loop as jmo_loop
from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.acquisition import multi_objective as jmo
from botorch_tpu.fit import _prepare_fit as j_prepare_fit
from botorch_tpu.models.gp import make_gp as j_make_gp
from botorch_tpu.optim.optimize import gen_batch_initial_conditions as j_gen_ics
from botorch_tpu.sampling.sobol import sobol_table as j_sobol_table
from botorch_tpu.test_functions.multi_objective import BraninCurrin as JBraninCurrin
from botorch_tpu.utils import multi_objective as jmu
from botorch_tpu_torch import convert
from botorch_tpu_torch import mo_loop as tmo_loop
from botorch_tpu_torch.acquisition.multi_objective import make_in_graph_nehvi_cells
from botorch_tpu_torch.models.gp import make_gp
from botorch_tpu_torch.sampling.sobol import sobol_table as t_sobol_table
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin
from _torch_threads import _one_torch_thread  # noqa: F401


CAP, N0, D, M, Q, NMC = 12, 8, 2, 2, 2, 8
TINY = dict(num_restarts=2, raw_samples=8, fit_restarts=2, fit_maxiter=8, acq_maxiter=8)
# bench.py:188-201 (config 4)
CONFIG4 = dict(num_restarts=4, raw_samples=32, fit_restarts=2, fit_maxiter=15, acq_maxiter=15,
               mc_samples=32, q=4)
REPLICA_MEAN = 0.872  # BASELINE.md: the BoTorch CPU replica's HV fraction, 3 seeds


def test_init_state_and_observed_hypervolume_match_reference():
    prob_t, prob_j = BraninCurrin(negate=True), JBraninCurrin(negate=True)
    st_t, X0_t = tmo_loop.init_mo_state(10, D, M, 90, seed=0, device="cpu")

    @jax.jit
    def reference():
        st, X0 = jmo_loop.init_mo_state(10, D, M, 90, seed=0)
        st = jmo_loop.append_mo_observations(st, X0, prob_j(X0))
        return X0, st.X, st.Y, jmu.hypervolume_2d(st.Y[:10], prob_j.ref_point)

    X0_j, X_j, Y_j, hv_j = reference()
    np.testing.assert_array_equal(X0_t.numpy(), np.asarray(X0_j))
    np.testing.assert_array_equal(st_t.X.numpy(), np.asarray(X_j))
    assert st_t.Y.shape == (90, M) and st_t.n == 0
    st_t = tmo_loop.append_mo_observations(st_t, X0_t, prob_t(X0_t))
    np.testing.assert_allclose(st_t.Y.numpy(), np.asarray(Y_j), rtol=1e-6, atol=1e-5)
    assert st_t.n == 10 and st_t.Y[10:].abs().sum() == 0
    # `observed_hypervolume` of the JAX package is its `hypervolume_2d` (m = 2)
    hv_t = tmo_loop.observed_hypervolume(st_t, prob_t.ref_point)
    assert hv_t > 0 and hv_t == pytest.approx(float(hv_j), rel=1e-6)
    with pytest.raises(ValueError):
        tmo_loop.append_mo_observations(st_t, torch.zeros(81, D), torch.zeros(81, M))


@jax.jit
def _history():
    """A 8-point history of two smooth objectives in a 12-row buffer (the
    reference's `test_mo_step_sequential_greedy_q2`)."""
    st, X0 = jmo_loop.init_mo_state(N0, D, M, CAP, seed=0)
    Y0 = jnp.stack([jnp.sum(jnp.sin(3 * X0), -1), jnp.sum(jnp.cos(2 * X0), -1)], -1)
    return jmo_loop.append_mo_observations(st, X0, Y0)


REF = np.array([-2.0, -2.0], np.float32)


def test_mo_bo_step_against_reference():
    st_j = _history()
    sob_j = j_sobol_table(Q * D, scramble=True, seed=1)

    @jax.jit
    def reference(state, key):
        """The reference's step, and the random draws inside it re-derived
        from its key: the fit's restart starts, the base samples and each
        pick's initial conditions."""
        ref = jnp.asarray(REF)
        cand, val, params = jmo_loop._mo_bo_step(state, key, sob_j, ref, q=Q, mc_samples=NMC,
                                                 **TINY)
        k_fit, k_acq, k_base = jax.random.split(key, 3)
        mask = jnp.arange(CAP) < state.n
        model = j_make_gp(state.X, state.Y, mask=mask)
        _, _, x0, _, _ = j_prepare_fit(model, k_fit, TINY["fit_restarts"])
        fitted = model.replace(params=params, _cache=None)
        cache = fitted.train_chol()
        base = jmc.draw_fresh_base_samples(CAP + Q, M, NMC, k_base, seed=23)
        lo, up = jmo.make_in_graph_nehvi_cells(fitted, cache, state.X, base[:, :CAP], ref,
                                               baseline_mask=mask)
        skip = (state.n.astype(jnp.uint32) + 1) * jnp.uint32(TINY["raw_samples"])
        ics = []
        for j in range(Q):
            masks, signs = jmo._subset_masks(1 + j)
            acqf = jmo.qLogNoisyExpectedHypervolumeImprovement(
                model=fitted, cache=cache, base_samples=base[:, :CAP + 1 + j], X_baseline=state.X,
                ref_point=ref, masks=masks, signs=signs, baseline_mask=mask, cell_lower=lo,
                cell_upper=up, X_pending=cand[:j] if j else None)
            k_acq, sub = jax.random.split(k_acq)
            ics.append(j_gen_ics(acqf, jnp.stack([jnp.zeros(D), jnp.ones(D)]), 1,
                                 TINY["num_restarts"], TINY["raw_samples"], sub, sobol=sob_j,
                                 sobol_skip=skip + jnp.uint32(j * TINY["raw_samples"])))
        return cand, val, params, x0, base, jnp.stack(ics)

    cand_j, val_j, params_j, x0_j, base_j, ics_j = reference(st_j, jax.random.PRNGKey(0))
    st_t = tmo_loop.MOBOState(X=torch.tensor(np.asarray(st_j.X)),
                              Y=torch.tensor(np.asarray(st_j.Y)), n=int(st_j.n))
    cand_t, val_t, params_t = tmo_loop._mo_bo_step(
        st_t, t_sobol_table(Q * D, scramble=True, seed=1), make_generator(0, "cpu"), REF, q=Q,
        mc_samples=NMC, fit_x0=np.array(x0_j), initial_conditions=torch.tensor(np.array(ics_j)),
        base_samples=np.array(base_j), **TINY)
    pt = convert.gp_params_to_numpy(params_t)
    for f in convert.GPParams.FIELDS:
        np.testing.assert_allclose(pt[f], np.asarray(getattr(params_j, f)), atol=5e-3, err_msg=f)
    assert cand_t.shape == (Q, D) and torch.all((cand_t >= 0) & (cand_t <= 1))
    cand_j = np.asarray(cand_j)
    for j in range(Q):
        if np.abs(cand_t[j].numpy() - cand_j[j]).max() <= 5e-3:
            continue
        # the port's pick-j acquisition, its earlier picks pending
        mask = torch.arange(CAP) < st_t.n
        model = make_gp(st_t.X, st_t.Y, mask=mask, device="cpu").replace(params=params_t)
        cache = model.train_chol()
        base = torch.tensor(np.array(base_j))
        cells = make_in_graph_nehvi_cells(model, cache, st_t.X, base[:, :CAP], torch.tensor(REF),
                                          baseline_mask=mask)
        acqf = tmo_loop._qlognehvi(model, cache, st_t, base, torch.tensor(REF), cells, 1 + j,
                                   cand_t[:j] if j else None)
        at_port = float(acqf(cand_t[j:j + 1][None]))
        at_ref = float(acqf(torch.tensor(cand_j[j:j + 1])[None]))
        assert at_ref <= at_port + 1e-3 * max(1.0, abs(at_port)), (j, at_ref, at_port)
    assert float(val_t) == pytest.approx(float(val_j), rel=5e-3, abs=5e-3)


def test_public_mo_bo_step_is_the_step():
    st_j = _history()
    st = tmo_loop.MOBOState(X=torch.tensor(np.asarray(st_j.X)),
                            Y=torch.tensor(np.asarray(st_j.Y)), n=int(st_j.n))
    sob = t_sobol_table(Q * D, seed=1)
    small = dict(TINY, fit_maxiter=3, acq_maxiter=3, mc_samples=NMC, q=Q)
    cand, val = tmo_loop.mo_bo_step(st, sob, REF, make_generator(4, "cpu"), device="cpu", **small)
    cand2, val2, _ = tmo_loop._mo_bo_step(st, sob, make_generator(4, "cpu"), REF, **small)
    assert torch.equal(cand, cand2) and torch.equal(val, val2)
    assert cand.shape == (Q, D) and float((cand[0] - cand[1]).abs().max()) > 1e-4
    joint, _ = tmo_loop.mo_bo_step(st, sob, REF, make_generator(4, "cpu"), device="cpu",
                                   sequential=False, **small)
    assert joint.shape == (Q, D) and torch.isfinite(joint).all()


def test_run_mo_bo_loop_small():
    prob = BraninCurrin(negate=True)
    st = tmo_loop.run_mo_bo_loop(prob, d=D, m=M, ref_point=prob.ref_point, n_init=10,
                                 iterations=2, q=2, seed=0, device="cpu", mc_samples=NMC, **TINY)
    assert st.n == 14 and st.X.shape == (14, D) and st.Y.shape == (14, M)
    assert torch.isfinite(st.Y).all() and torch.all((st.X >= 0) & (st.X <= 1))
    prefix = tmo_loop.MOBOState(X=st.X, Y=st.Y, n=10)
    hv, hv0 = (tmo_loop.observed_hypervolume(s, prob.ref_point) for s in (st, prefix))
    assert hv >= hv0 > 0


def config4_hv_fractions(seeds, package):
    """Config 4 (`bench.py:188-201`: BraninCurrin, n_init = 10, 20
    iterations, q = 4 sequential greedy, 32 MC samples) in one package, as
    HV fractions of `max_hv`, seed by seed (the Sobol scramble and the
    random stream both from the seed)."""
    fracs = []
    for seed in seeds:
        if package == "port":
            prob = BraninCurrin(negate=True)
            st = tmo_loop.run_mo_bo_loop(prob, d=2, m=2, ref_point=prob.ref_point, n_init=10,
                                         iterations=20, seed=seed, device="cpu", **CONFIG4)
            hv = tmo_loop.observed_hypervolume(st, prob.ref_point)
        else:
            prob = JBraninCurrin(negate=True)
            st = jmo_loop.run_mo_bo_loop(prob, d=2, m=2, ref_point=prob.ref_point, n_init=10,
                                         iterations=20, key=jax.random.PRNGKey(seed), seed=seed,
                                         **CONFIG4)
            hv = jmo_loop.observed_hypervolume(st, prob.ref_point)
        fracs.append(hv / prob.max_hv)
    return fracs


@pytest.mark.slow
def test_config4_hv_fraction_over_seeds_matches_reference():
    """Config 4 over seeds 1-8 in both packages on the CPU: the port's mean
    HV fraction is at least the JAX package's mean less 0.02, and at least
    the BoTorch CPU replica's mean (0.872, `BASELINE.md`)."""
    seeds = range(1, 9)
    port, ref = config4_hv_fractions(seeds, "port"), config4_hv_fractions(seeds, "jax")
    mean_t, mean_j = float(np.mean(port)), float(np.mean(ref))
    print(f"config-4 HV fraction over seeds 1-8: port {mean_t:.4f} {port}, "
          f"JAX package {mean_j:.4f} {ref}")
    assert mean_t >= mean_j - 0.02, (port, ref)
    assert mean_t >= REPLICA_MEAN, port
