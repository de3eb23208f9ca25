"""Port parity for `fit.py`: bounds, prior draws, restart setup, and
`fit_gp` from the JAX-drawn restart starts against botorch_tpu's `fit_gp`.

The fitted hyperparameters are compared at atol 2e-2 in raw (log) space
and the final MAP objective at rtol 1e-4: both run 15-30 float32 L-BFGS
iterations on the same surface from the same starts, so they end within
float32 rounding of the same point along the flat directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from botorch_tpu import fit as jfit
from botorch_tpu.models import gp as jgp
from botorch_tpu_torch import convert
from botorch_tpu_torch import fit as tfit
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.settings import make_generator
from _torch_threads import _one_torch_thread  # noqa: F401


def _problem(n=12, capacity=None, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    Y = (np.sin(6 * X[:, 0]) + np.cos(4 * X[:, 1])).astype(np.float32)
    mask = None
    if capacity:
        X = np.concatenate([X, np.zeros((capacity - n, 2), np.float32)])
        Y = np.concatenate([Y, np.zeros(capacity - n, np.float32)])
        mask = np.arange(capacity) < n
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None],
                     mask=None if mask is None else jnp.asarray(mask))
    tm = tgp.make_gp(X, Y[:, None], mask=mask, device="cpu")
    return jm, tm


def test_bounds_and_flat_order():
    jm, tm = _problem()
    for jb, tb in zip(jfit.param_bounds(jm), tfit.param_bounds(tm)):
        np.testing.assert_array_equal(convert.flatten_params(tb).numpy(),
                                      np.asarray(ravel_pytree(jb)[0]))


def test_prepare_fit_starts_and_objective():
    jm, tm = _problem(capacity=20)
    obj, unflatten, x0, lo, hi = tfit._prepare_fit(tm, make_generator(0, "cpu"), 4)
    assert x0.shape == (4, 5) and x0.dtype == torch.float32
    np.testing.assert_array_equal(x0[0].numpy(), np.asarray(ravel_pytree(jm.params)[0]))
    # prior draws lie inside the box; the mean and outputscale are pinned
    assert torch.all(x0 >= lo) and torch.all(x0 <= hi)
    assert torch.all(x0[:, 0] == x0[0, 0]) and torch.all(x0[:, 3] == x0[0, 3])
    j_obj, _, jx0, _, _ = jfit._prepare_fit(jm, jax.random.PRNGKey(0), 4)
    vals = obj(torch.tensor(np.asarray(jx0)))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jax.jit(jax.vmap(j_obj))(jx0)),
                               rtol=1e-4)


def test_prior_draws_follow_the_priors():
    _, tm = _problem()
    p = tfit.sample_params_from_priors(make_generator(3, "cpu"), tm, 4000)
    assert p.raw_lengthscale.shape == (4000, 1, 2) and p.raw_noise.shape == (4000, 1)
    # LogNormal(sqrt2 + log(2)/2, sqrt3) lengthscale; LogNormal(-4, 1) noise
    ls_loc = np.sqrt(2) + 0.5 * np.log(2)
    raw_ls = p.raw_lengthscale.numpy().ravel()
    inside = raw_ls[(raw_ls > np.log(0.025) + 1e-3) & (raw_ls < np.log(1e4) - 1e-3)]
    assert np.median(inside) == pytest.approx(ls_loc, abs=0.15)
    assert float(p.raw_noise.mean()) == pytest.approx(-4.0, abs=0.1)
    assert float(p.raw_noise.std()) == pytest.approx(1.0, abs=0.1)


@pytest.mark.parametrize("capacity,restarts,maxiter", [(None, 3, 30), (20, 2, 15)],
                         ids=["dense", "padded-loop-budget"])
def test_fit_gp_from_jax_starts(capacity, restarts, maxiter):
    jm, tm = _problem(capacity=capacity)
    key = jax.random.PRNGKey(7)
    fitted_j = jfit.fit_gp(jm, key, num_restarts=restarts, maxiter=maxiter)
    _, _, jx0, _, _ = jfit._prepare_fit(jm, key, restarts)
    fitted_t = tfit.fit_gp(tm, num_restarts=restarts, maxiter=maxiter,
                           x0=np.array(jx0), device="cpu")
    pt = convert.gp_params_to_numpy(fitted_t.params)
    for f in tgp.GPParams.FIELDS:
        np.testing.assert_allclose(pt[f], np.asarray(getattr(fitted_j.params, f)), atol=2e-2)
    loss_t = float(tm.map_objective(fitted_t.params))
    loss_j = float(jax.jit(lambda m, p: m.map_objective(p))(jm, fitted_j.params))
    assert loss_t == pytest.approx(loss_j, rel=1e-4, abs=1e-4)
    assert loss_t < float(tm.map_objective(tm.params))


def test_fit_gp_own_draws_and_device():
    _, tm = _problem()
    fitted = tfit.fit_gp(tm, make_generator(1, "cpu"), num_restarts=3, maxiter=20,
                         device="cpu")
    assert fitted.params.raw_lengthscale.shape == (1, 2)
    assert float(tm.map_objective(fitted.params)) < float(tm.map_objective(tm.params))
