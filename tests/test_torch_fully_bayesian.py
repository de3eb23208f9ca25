"""Port parity for the fully-Bayesian (SAAS) model against botorch_tpu on
the CPU: `models/fully_bayesian.py`, `posteriors/fully_bayesian.py`, the
ensemble parts of `models/gp.py` and `acquisition/analytic.py`, the SAAS
priors, `IndexSampler` and the NUTS-state helpers of `convert.py`.

Tolerances, all float32 unless named:
* The SAAS potential (batched over chains) and its gradient, with and
  without a padding mask and with fixed noise, both by autograd and in
  the fit's closed form: values within rtol 1e-5; gradients within 1e-4
  of their largest entry, since each package's float32 gradient is
  2e-5-5e-5 of that from the float64 one at these inputs (the noise
  draws make K ill-conditioned). Under float64 (`jax.enable_x64`): values
  within rtol 1e-6 and gradients within 5e-6 of the largest entry (the
  JAX kernel accumulates `x z^T` in float32 even under x64).
* The closed-form float64 gradient within 1e-12 of the largest entry of
  the port's autograd gradient.
* Prior log-densities, `load_saas_samples` and `median_lengthscales`:
  rtol 1e-6.
* The ensemble posterior, the mixture helpers and the six analytic
  acquisitions over a 6-member ensemble against the JAX package's
  per-candidate `vmap`: rtol 1e-4, and the acquisition values rtol 3e-4
  as in `test_torch_analytic.py` (deep in the tail log EI ~ -u^2/2
  doubles the ~1e-4 relative rounding of the float32 posterior).
* The ensemble `train_chol` with one ill-conditioned member: the same
  jitter rung as the JAX package, and the other members' factors within
  1e-5 (the ill-conditioned member's own factor rounds apart).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition.analytic import make_acqf as j_make_acqf
from botorch_tpu.models import priors as jpriors
from botorch_tpu.models.fully_bayesian import load_saas_samples as j_load
from botorch_tpu.models.fully_bayesian import make_saas_potential as j_make_saas_potential
from botorch_tpu.models.fully_bayesian import median_lengthscales as j_median
from botorch_tpu.models.gp import GPParams as JGPParams
from botorch_tpu.models.gp import make_gp as j_make_gp
from botorch_tpu.posteriors import fully_bayesian as jfb
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition.analytic import ANALYTIC
from botorch_tpu_torch.acquisition.analytic import make_acqf as t_make_acqf
from botorch_tpu_torch.models import priors as tpriors
from botorch_tpu_torch.models.fully_bayesian import (
    fit_saas_gp,
    init_saas_chains,
    load_saas_samples,
    make_saas_potential,
    make_saas_potential_and_grad,
    median_lengthscales,
)
from botorch_tpu_torch.models.gp import GPParams, make_gp
from botorch_tpu_torch.ops.chol import jitter_rung, psd_safe_cholesky
from botorch_tpu_torch.posteriors import fully_bayesian as tfb
from botorch_tpu_torch.sampling.samplers import IndexSampler
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.utils.transforms import is_ensemble, is_fully_bayesian
from _torch_threads import _one_torch_thread  # noqa: F401


N, D, NV, S = 12, 4, 10, 6
K_DIM = 3 + 1 + D


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(N, D))
    Y = np.sin(6 * X[:, 0]) + 0.5 * X[:, 1]
    mask = np.arange(N) < NV
    return X, Y, mask


def _draws(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    base = np.r_[0.0, 0.0, math.log(0.01), math.log(0.1), np.zeros(D)]
    return scale * rng.normal(size=(n, K_DIM)) + base


@pytest.fixture(scope="module")
def ensembles():
    X, Y, mask = _data()
    Z = _draws(S, 1, scale=0.3).astype(np.float32)
    X32, Y32 = X.astype(np.float32), Y.astype(np.float32)
    jb = j_make_gp(jnp.asarray(X32), jnp.asarray(Y32)[:, None], kernel="matern52",
                   use_outputscale=True, mask=jnp.asarray(mask))
    tb = make_gp(X32, Y32[:, None], kernel="matern52", use_outputscale=True, mask=mask, device="cpu")
    return j_load(jnp.asarray(Z), jb), load_saas_samples(torch.tensor(Z), tb), Z


def _reference_potential(X, Y, Yvar, mask, Z, dtype):
    """The JAX package's SAAS potential and gradient, mapped over chains."""
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        pj, zdim, infer = j_make_saas_potential(
            jnp.asarray(X, jdt), jnp.asarray(Y, jdt),
            None if Yvar is None else jnp.asarray(Yvar, jdt),
            mask=None if mask is None else jnp.asarray(mask))
        vj, gj = jax.jit(jax.vmap(jax.value_and_grad(pj)))(jnp.asarray(Z, jdt))
        return np.asarray(vj), np.asarray(gj), zdim, infer


@pytest.mark.parametrize("masked,fixed_noise", [(False, False), (True, False), (True, True)],
                         ids=["unmasked", "masked", "masked-fixed-noise"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_potential_and_gradient_match_reference(masked, fixed_noise, dtype):
    """Both of the port's forms against the JAX package's `value_and_grad`:
    the potential with autograd's gradient (`make_saas_potential`), and the
    fit's potential and gradient in closed form
    (`make_saas_potential_and_grad`); in float64 the closed form is also
    held to autograd's gradient, to 1e-12 of its largest entry."""
    X, Y, mask = _data()
    Y = (Y - Y[mask].mean()) / Y[mask].std()
    Yvar = np.full(N, 0.05) if fixed_noise else None
    Z = _draws(3, 2)[:, [0, 1, 3, 4, 5, 6, 7] if fixed_noise else slice(None)]
    m = mask if masked else None
    vj, gj, zdim_j, infer_j = _reference_potential(X, Y, Yvar, m, Z, dtype)
    tdt = getattr(torch, dtype)
    t = lambda a: None if a is None else torch.tensor(a, dtype=tdt)  # noqa: E731
    args, tmask = (t(X), t(Y), t(Yvar)), None if m is None else torch.tensor(m)
    pt, zdim_t, infer_t = make_saas_potential(*args, mask=tmask)
    assert (zdim_t, infer_t) == (zdim_j, infer_j) == (K_DIM - fixed_noise, not fixed_noise)
    z = t(Z).requires_grad_(True)
    v = pt(z)
    (g,) = torch.autograd.grad(v.sum(), z)
    v_cf, g_cf = make_saas_potential_and_grad(*args, mask=tmask)(t(Z))
    vtol, gtol = (1e-5, 1e-4) if dtype == "float32" else (1e-6, 5e-6)
    for value, grad in ((v.detach(), g), (v_cf, g_cf)):
        np.testing.assert_allclose(value.numpy(), vj, rtol=vtol)
        np.testing.assert_allclose(grad.numpy(), gj, atol=gtol * np.abs(gj).max())
    if dtype == "float64":
        torch.testing.assert_close(v_cf, v.detach(), rtol=1e-12, atol=0)
        torch.testing.assert_close(g_cf, g, rtol=0, atol=1e-12 * float(g.abs().max()))


def test_priors_match_reference():
    x = np.geomspace(1e-4, 1e3, 41).astype(np.float32)
    for jp, tp in ((jpriors.HalfCauchy(0.1), tpriors.HalfCauchy(0.1)),
                   (jpriors.HalfCauchy(1.0), tpriors.HalfCauchy(1.0))):
        np.testing.assert_allclose(tp.log_prob(torch.tensor(x)).numpy(),
                                   np.asarray(jp.log_prob(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
        assert tp.mode == jp.mode
    xn = np.linspace(-5, 5, 41).astype(np.float32)
    for loc, scale in ((0.0, 1.0), (0.5, 2.0)):
        np.testing.assert_allclose(
            tpriors.Normal(loc, scale).log_prob(torch.tensor(xn)).numpy(),
            np.asarray(jpriors.Normal(loc, scale).log_prob(jnp.asarray(xn))), rtol=1e-6, atol=1e-6)
    gen = make_generator(0, "cpu")
    hc = tpriors.HalfCauchy(0.1).sample(gen, (20000,))
    assert (hc >= 0).all() and abs(float(hc.median()) - 0.1) < 0.01
    nz = tpriors.Normal(0.5, 2.0).sample(gen, (20000,))
    assert abs(float(nz.mean()) - 0.5) < 0.05 and abs(float(nz.std()) - 2.0) < 0.05


def test_load_saas_samples_matches_reference(ensembles):
    jm, tm, _ = ensembles
    for f in GPParams.FIELDS:
        np.testing.assert_allclose(getattr(tm.params, f).numpy(), np.asarray(getattr(jm.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert tm.batch_shape == tuple(jm.batch_shape) == (S,)
    assert is_fully_bayesian(tm) and is_ensemble(tm)
    assert tm.kernel == "matern52" and tm.use_outputscale
    # fixed noise keeps the base model's noise for every member
    X, Y, _ = _data()
    Yvar = np.full((N, 1), 0.05, np.float32)
    Z = _draws(S, 4)[:, [0, 1, 3, 4, 5, 6, 7]].astype(np.float32)
    jf = j_load(jnp.asarray(Z), j_make_gp(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)[:, None],
                                          jnp.asarray(Yvar), kernel="matern52", use_outputscale=True))
    tf = load_saas_samples(torch.tensor(Z), make_gp(X, Y[:, None], Yvar, kernel="matern52",
                                                    use_outputscale=True, device="cpu"))
    for f in GPParams.FIELDS:
        np.testing.assert_allclose(getattr(tf.params, f).numpy(), np.asarray(getattr(jf.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("members", [6, 5])
def test_median_lengthscales_matches_reference(members):
    """An even ensemble averages its two middle draws (`jnp.median`)."""
    X, Y, _ = _data()
    Z = _draws(members, 5, scale=1.0).astype(np.float32)
    jb = j_make_gp(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)[:, None],
                   kernel="matern52", use_outputscale=True)
    tb = make_gp(X, Y[:, None], kernel="matern52", use_outputscale=True, device="cpu")
    got = median_lengthscales(load_saas_samples(torch.tensor(Z), tb)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_median(j_load(jnp.asarray(Z), jb))), rtol=1e-6)
    if members % 2 == 0:
        ls = np.sort(np.asarray(load_saas_samples(torch.tensor(Z), tb).params.lengthscale[:, 0]), 0)
        assert not np.allclose(got, ls[members // 2 - 1])


def test_mixture_helpers_match_reference(ensembles):
    jm, tm, _ = ensembles
    Xq = np.random.default_rng(6).uniform(size=(3, D)).astype(np.float32)
    levels = (0.1, 0.5, 0.9)

    @jax.jit
    def reference(model, x):
        post = model.posterior(x)
        return (post.mean, post.cov, jfb.mixture_mean(post), jfb.mixture_variance(post),
                jfb.mixture_covariance(post), [jfb.mixture_quantile(post, q) for q in levels])

    mean_j, cov_j, *mix_j, quant_j = reference(jm, jnp.asarray(Xq))
    pt = tm.posterior(torch.tensor(Xq))
    np.testing.assert_allclose(pt.mean.numpy(), np.asarray(mean_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt.cov.numpy(), np.asarray(cov_j), rtol=1e-4, atol=1e-5)
    for fn, ref in zip(("mixture_mean", "mixture_variance", "mixture_covariance"), mix_j):
        np.testing.assert_allclose(getattr(tfb, fn)(pt).numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5, err_msg=fn)
    for level, ref in zip(levels, quant_j):
        np.testing.assert_allclose(tfb.mixture_quantile(pt, level).numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    # the population variance of the member means (divided by S, not S - 1)
    var = tfb.mixture_variance(pt) - torch.mean(pt.variance, 0)
    torch.testing.assert_close(var, torch.var(pt.mean, 0, correction=0))


def _acq_kwargs(name, best_f):
    if name == "UCB":
        return {"beta": 0.3}
    return {} if name == "PosteriorMean" else {"best_f": best_f}


def _candidates():
    """Candidates near the incumbent, near other data and far from it."""
    X, Y, mask = _data()
    rng = np.random.default_rng(7)
    best = X[np.argmax(np.where(mask, Y, -np.inf))]
    Xc = np.concatenate([best + 0.05 * rng.normal(size=(3, D)), X[:3] + 0.02 * rng.normal(size=(3, D)),
                         rng.uniform(size=(4, D))])
    return np.clip(Xc, 0, 1).astype(np.float32)[:, None, :], float(Y[mask].max())


@pytest.fixture(scope="module")
def reference_values(ensembles):
    """The six JAX acquisitions mapped over the candidates, in one program."""
    jm, _, _ = ensembles
    Xc, best_f = _candidates()
    names = sorted(ANALYTIC)

    @jax.jit
    def values(model, x):
        return {n: jax.vmap(j_make_acqf(n, model, **_acq_kwargs(n, best_f)))(x) for n in names}

    return {n: np.asarray(v) for n, v in values(jm, jnp.asarray(Xc)).items()}


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_ensemble_analytic_values_match_reference(ensembles, reference_values, name):
    """The port's t-batch `(b, 1, d)` over an ensemble against the JAX
    package mapping one candidate at a time; one candidate's value does not
    change with the rest of the batch."""
    _, tm, _ = ensembles
    Xc, best_f = _candidates()
    acqf = t_make_acqf(name, tm, **_acq_kwargs(name, best_f))
    vt = acqf(torch.tensor(Xc)).numpy()
    assert vt.shape == (len(Xc),)
    np.testing.assert_allclose(vt, reference_values[name], rtol=3e-4, atol=1e-6)
    np.testing.assert_array_equal(acqf(torch.tensor(Xc[2:5])).numpy(), vt[2:5])


def test_ensemble_train_chol_picks_one_rung():
    """One ill-conditioned member moves the whole ensemble up the jitter
    ladder, as the JAX package's `psd_safe_cholesky` on the `(S, n, n)`
    stack does: the other members' factors are not their rung-0 factors."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(N, 2)).astype(np.float32)
    X[4:8] = X[0] + rng.uniform(-1e-4, 1e-4, size=(4, 2)).astype(np.float32)
    Y = np.sin(6 * X[:, 0]).astype(np.float32)
    members = 3
    ls = np.full((members, 1, 2), 0.3, np.float32)
    noise = np.full((members, 1), 1e-3, np.float32)
    ls[1], noise[1] = 0.01, 1e-12  # the ill-conditioned member
    p = {"mean": np.zeros((members, 1), np.float32), "raw_lengthscale": np.log(ls),
         "raw_outputscale": np.zeros((members, 1), np.float32), "raw_noise": np.log(noise)}
    tm = make_gp(X, Y[:, None], kernel="matern52", use_outputscale=True, device="cpu")
    tm = tm.replace(params=convert.gp_params_from_numpy(p), _is_fully_bayesian=True)
    jm = j_make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None], kernel="matern52", use_outputscale=True)
    jm = jm.replace(params=JGPParams(**{f: jnp.asarray(v) for f, v in p.items()}),
                    _is_fully_bayesian=True, _cache=None)
    K = tm._train_cov(tm.params.output(0), 0)
    per_member = jitter_rung(K, batch_dims=1)
    assert per_member.tolist()[0] == per_member.tolist()[2] == 0 and int(per_member[1]) > 0
    L = tm.train_chol()[0][:, 0]
    Lj = np.asarray(jax.jit(lambda m: m.train_chol()[0])(jm))[:, 0]
    np.testing.assert_allclose(L.numpy()[[0, 2]], Lj[[0, 2]], rtol=1e-5, atol=1e-5)
    rung0 = psd_safe_cholesky(K[0])
    assert (L[0] - rung0).abs().max() > 1e-4


def test_index_sampler():
    rng = np.random.default_rng(8)
    mean = torch.tensor(rng.normal(size=(S, 3, 1)), dtype=torch.float32)

    class Post:
        pass

    post = Post()
    post.mean = mean
    sampler = IndexSampler(sample_shape=(4, 5), seed=3)
    idx = torch.tensor([[0, 5, 2, 2, 1]] * 4)
    torch.testing.assert_close(sampler(post, indices=idx), mean[idx])
    a = sampler(post)
    assert a.shape == (4, 5, 3, 1) and torch.equal(a, sampler(post))
    drawn = sampler.indices(S, device="cpu")
    assert drawn.shape == (4, 5) and drawn.min() >= 0 and drawn.max() < S
    w = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0, 0.0])
    picked = IndexSampler(sample_shape=(200,), weights=w).indices(S, device="cpu")
    assert set(picked.tolist()) == {1, 4}


def test_convert_nuts_state():
    rng = np.random.default_rng(9)
    chol = np.linalg.cholesky(np.eye(K_DIM) + 0.1)
    state = convert.nuts_adaptation_from_numpy(np.float32(0.07), chol)
    assert state["step_size"].shape == () and float(state["step_size"]) == pytest.approx(0.07)
    np.testing.assert_allclose(state["chol_cov"].numpy(), chol, rtol=1e-6)
    z = rng.normal(size=(S, K_DIM))
    torch.testing.assert_close(convert.saas_draws_from_numpy(z, torch.float64), torch.tensor(z))
    with pytest.raises(ValueError):
        convert.saas_draws_from_numpy(z[None])


def test_fit_saas_gp_tiny_budget():
    """The fit end to end on the CPU: the ensemble's size and shapes and
    the NUTS statistics (the reference's own tiny-budget test,
    `tests/test_models_extra.py`)."""
    X, Y, mask = _data()
    chains, per_chain, thinning = 2, 8, 4
    model, stats = fit_saas_gp(X, Y, make_generator(0, "cpu"), num_warmup=16,
                               num_samples=chains * per_chain, thinning=thinning,
                               num_chains=chains, max_depth=3, mask=mask, device="cpu")
    assert model.batch_shape == (chains * per_chain // thinning,)
    assert model.params.raw_lengthscale.shape == (4, 1, D)
    assert is_fully_bayesian(model) and model.kernel == "matern52" and model.use_outputscale
    assert median_lengthscales(model).shape == (D,)
    post = model.posterior(torch.tensor(X[:3], dtype=torch.float32))
    assert post.mean.shape == (4, 3, 1) and torch.isfinite(post.mean).all()
    assert 0.0 <= float(stats["accept_prob"]) <= 1.0 and stats["chol_cov"].shape == (K_DIM, K_DIM)
    z0 = init_saas_chains(make_generator(1, "cpu"), 3, D, True)
    assert z0.shape == (3, K_DIM) and abs(float(z0[:, 2].mean()) - math.log(0.01)) < 1.5


@pytest.mark.slow
def test_saas_posterior_over_seeds_matches_reference():
    """The SAAS posterior that NUTS samples at a fixed history, port
    against the JAX package over 16 seeds each (`tools/saas_posterior.py`:
    config 3's fit on 20 Branin-embedded points in d = 8). Float32 chains of
    the two packages part within one fit even from the same draws, so the
    posterior is compared as a distribution: each package's mean over
    seeds of the log median lengthscale per dimension, of its mean over
    the six distractor dimensions, and of the ensemble mean at 32 test
    points, agree within 4 standard errors."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from saas_posterior import FIT, compare, fit_stats, history

    from botorch_tpu.models.fully_bayesian import fit_saas_gp as j_fit_saas_gp

    X, Y, mask, X_test = history()
    port, ref = [], []
    for seed in range(1, 17):
        port.append(fit_stats(seed, "cpu"))
        model, _ = j_fit_saas_gp(jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(seed),
                                 mask=jnp.asarray(mask), **FIT)
        mean = np.asarray(model.posterior(jnp.asarray(X_test)).mean).reshape(-1, len(X_test))
        ref.append({"log_median_ls": np.log(np.asarray(j_median(model))), "test_mean": mean.mean(0)})
    z = compare({"port": port, "jax": ref})
    print(f"z of the log median lengthscales {np.round(z['z_log_ls'], 2).tolist()}, "
          f"of their distractor mean {z['z_distractors']:.2f}, "
          f"max |z| of the test-point means {z['z_mean_max_abs']:.2f}")
    assert np.max(np.abs(z["z_log_ls"])) <= 4.0 and abs(z["z_distractors"]) <= 4.0
    assert z["z_mean_max_abs"] <= 4.0
