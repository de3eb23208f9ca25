"""Port parity for `models/gp.py`, `models/priors.py`,
`posteriors/gaussian.py` and `convert.py` against botorch_tpu on the CPU.

The JAX model's hyperparameters cross as numpy arrays (`convert.py`);
`make_gp`, `mll`, `log_prior`, `map_objective` (value and gradient),
`train_chol` and `posterior` must agree at rtol 1e-4: every quantity goes
through a float32 Cholesky of a GP covariance whose condition number is
~1e3, which costs ~1e-4 relative in the worst entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from botorch_tpu.models import gp as jgp
from botorch_tpu.models import priors as jpr
from botorch_tpu_torch import convert
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.models import priors as tpr
from botorch_tpu_torch.posteriors.gaussian import GaussianPosterior
from _torch_threads import _one_torch_thread  # noqa: F401


RTOL, ATOL = 1e-4, 1e-5


def _data(n=12, d=2, capacity=None, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    Y = (np.sin(6 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.normal(size=n)).astype(np.float32)
    if capacity is None:
        return X, Y, None
    Xp = np.zeros((capacity, d), np.float32)
    Yp = np.zeros((capacity,), np.float32)
    Xp[:n], Yp[:n] = X, Y
    return Xp, Yp, np.arange(capacity) < n


def _params_np(seed=1, d=2):
    rng = np.random.default_rng(seed)
    return {
        "mean": rng.normal(size=(1,)).astype(np.float32) * 0.1,
        "raw_lengthscale": np.log(rng.uniform(0.1, 0.6, size=(1, d))).astype(np.float32),
        "raw_outputscale": np.zeros((1,), np.float32),
        "raw_noise": np.log(rng.uniform(1e-3, 1e-2, size=(1,))).astype(np.float32),
    }


def _pair(kernel="rbf", capacity=None, seed=0):
    X, Y, mask = _data(capacity=capacity, seed=seed)
    pn = _params_np()
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None], kernel=kernel,
                     mask=None if mask is None else jnp.asarray(mask),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y[:, None], kernel=kernel, mask=mask, device="cpu",
                     params=convert.gp_params_from_numpy(pn))
    return jm, tm


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
@pytest.mark.parametrize("capacity", [None, 20], ids=["dense", "padded"])
def test_mll_prior_and_map_objective(kernel, capacity):
    jm, tm = _pair(kernel, capacity)
    _close(tm.Y_loc, jm.Y_loc, rtol=1e-6)
    _close(tm.Y_scale, jm.Y_scale, rtol=1e-6)
    _close(tm.mll(), jax.jit(lambda m: m.mll())(jm))
    _close(tm.log_prior(), jax.jit(lambda m: m.log_prior())(jm))
    # map objective value and gradient in the flat (ravel_pytree) order
    flat_j, unravel = ravel_pytree(jm.params)
    vj, gj = jax.jit(jax.value_and_grad(lambda v: jm.map_objective(unravel(v))))(flat_j)
    flat_t = convert.flatten_params(tm.params).requires_grad_(True)
    vt = tm.map_objective(convert.unflatten_params(flat_t, tm.params))
    (gt,) = torch.autograd.grad(vt, flat_t)
    np.testing.assert_array_equal(flat_t.detach().numpy(), np.asarray(flat_j))
    _close(vt, vj)
    _close(gt, gj, atol=1e-3)


def test_batched_params_are_restart_lanes():
    """Leading batch dims of GPParams are independent lanes (the fit's
    restarts), where the JAX package vmaps."""
    jm, tm = _pair("rbf", 20)
    rng = np.random.default_rng(3)
    flat0 = convert.flatten_params(tm.params)
    V = flat0[None].repeat(3, 1) + torch.tensor(rng.normal(size=(3, flat0.numel())) * 0.2,
                                                dtype=torch.float32)
    vals_t = tm.map_objective(convert.unflatten_params(V, tm.params))
    _, unravel = ravel_pytree(jm.params)
    vals_j = jax.jit(jax.vmap(lambda v: jm.map_objective(unravel(v))))(jnp.asarray(V.numpy()))
    assert vals_t.shape == (3,)
    _close(vals_t, vals_j)


def test_padding_is_exact():
    """A padded, masked model equals the dense model on the valid rows."""
    X, Y, mask = _data(capacity=20)
    pn = _params_np()
    dense = tgp.make_gp(X[:12], Y[:12, None], device="cpu",
                        params=convert.gp_params_from_numpy(pn))
    padded = tgp.make_gp(X, Y[:, None], mask=mask, device="cpu",
                         params=convert.gp_params_from_numpy(pn))
    _close(padded.mll(), dense.mll(), rtol=1e-6, atol=1e-5)
    Xq = torch.rand(5, 1, 2, generator=torch.Generator().manual_seed(0))
    p1, p2 = dense.posterior(Xq), padded.posterior(Xq)
    _close(p2.mean, p1.mean.detach().numpy(), rtol=1e-5)
    _close(p2.variance, p1.variance.detach().numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_train_chol_and_posterior(kernel):
    jm, tm = _pair(kernel, 20)
    L_t, a_t, Li_t = tm.train_chol()
    L_j, a_j, Li_j = jax.jit(lambda m: m.train_chol())(jm)
    _close(L_t, L_j, atol=1e-5)
    _close(a_t, a_j, atol=1e-2, rtol=1e-3)  # alpha = K^-1 r carries cond(K)
    _close(Li_t, Li_j, atol=1e-3, rtol=1e-3)
    Xq = np.random.default_rng(4).uniform(size=(7, 1, 2)).astype(np.float32)
    pt = tm.posterior(torch.tensor(Xq), cache=(L_t, a_t, Li_t))
    pj = jax.jit(jax.vmap(lambda x: jm.posterior(x)))(jnp.asarray(Xq))
    assert pt.mean.shape == (7, 1, 1) and pt.cov.shape == (7, 1, 1, 1)
    _close(pt.mean, pj.mean, atol=1e-4)
    _close(pt.variance, pj.variance, atol=1e-5, rtol=1e-3)
    pt_n = tm.posterior(torch.tensor(Xq), observation_noise=True)
    pj_n = jax.jit(jax.vmap(lambda x: jm.posterior(x, observation_noise=True)))(jnp.asarray(Xq))
    _close(pt_n.variance, pj_n.variance, atol=1e-5, rtol=1e-3)
    # joint posterior over q = 3 points
    Xj = np.random.default_rng(5).uniform(size=(3, 2)).astype(np.float32)
    cov_j = jax.jit(lambda x: jm.posterior(x).cov)(jnp.asarray(Xj))
    _close(tm.posterior(torch.tensor(Xj)).cov, cov_j, atol=1e-5, rtol=1e-3)


def test_default_init_and_standardization():
    X, Y, _ = _data()
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y))
    tm = tgp.make_gp(X, Y, device="cpu")
    for f in tgp.GPParams.FIELDS:
        _close(getattr(tm.params, f), getattr(jm.params, f), rtol=1e-6, atol=0)
    _close(tm.Y, jm.Y, rtol=1e-5, atol=1e-6)


def test_convert_round_trip():
    pn = _params_np()
    p = convert.gp_params_from_numpy(pn, dtype=torch.float64)
    back = convert.gp_params_to_numpy(p)
    for k in pn:
        np.testing.assert_array_equal(back[k], pn[k].astype(np.float64))
    with pytest.raises(NotImplementedError):
        convert.gp_params_from_numpy({**pn, "raw_kernel_weights": np.zeros((2, 1))})
    flat = convert.flatten_params(p)
    assert flat.shape == (5,)
    q = convert.unflatten_params(flat, p)
    assert all(torch.equal(getattr(q, f), getattr(p, f)) for f in tgp.GPParams.FIELDS)


@pytest.mark.parametrize(
    "tp_,jp_",
    [(tpr.dim_scaled_lognormal_lengthscale_prior(3), jpr.dim_scaled_lognormal_lengthscale_prior(3)),
     (tpr.lognormal_noise_prior(), jpr.lognormal_noise_prior()),
     (tpr.gamma_outputscale_prior(), jpr.gamma_outputscale_prior()),
     (tpr.gamma_noise_prior(), jpr.gamma_noise_prior()),
     (tpr.gamma_lengthscale_prior(), jpr.gamma_lengthscale_prior())],
    ids=["ls", "noise", "gamma-outputscale", "gamma-noise", "gamma-lengthscale"],
)
def test_priors(tp_, jp_):
    x = np.linspace(0.01, 5.0, 50).astype(np.float32)
    _close(tp_.log_prob(torch.tensor(x)), jp_.log_prob(jnp.asarray(x)), rtol=1e-5)
    assert tp_.mode == pytest.approx(jp_.mode)
    gen = torch.Generator().manual_seed(0)
    s = tp_.sample(gen, (4000,))
    assert s.shape == (4000,) and torch.isfinite(s).all()
    # distribution check: the sample median matches the reference's sample
    # median (different generators, so only in distribution)
    sj = np.asarray(jp_.sample(jax.random.PRNGKey(0), (4000,)))
    assert float(s.median()) == pytest.approx(float(np.median(sj)), rel=0.1, abs=0.05)


def test_gaussian_posterior_affine():
    A = torch.randn(2, 1, 3, 3, generator=torch.Generator().manual_seed(0))
    post = GaussianPosterior(mean=torch.zeros(2, 3, 1), cov=A @ A.transpose(-1, -2))
    assert post.batch_shape == (2,) and post.q == 3 and post.num_outputs == 1
    aff = post.affine(torch.tensor([1.0]), torch.tensor([2.0]))
    torch.testing.assert_close(aff.variance, 4 * post.variance)
    torch.testing.assert_close(aff.mean, torch.ones(2, 3, 1))
