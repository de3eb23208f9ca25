"""Port parity for `models/approximate_gp.py` (the SVGP of config 5) against
botorch_tpu on the CPU, at tiny sizes (n <= 96, M <= 24, d <= 3).

* `greedy_variance_reduction` picks the same pivots in float64, with and
  without quality scores (`greedy_improvement_reduction`), and `make_svgp`
  gives the same standardization and inducing points.
* On a model carried over from the JAX package (random variational and
  kernel parameters): the posterior mean and covariance, the full and the
  minibatch ELBO and the log prior within 1e-5 relative in float32; the
  gradient of the fit's loss within 1e-4 of its largest entry; analytic
  LogEI on the SVGP posterior within 1e-5.
* `fit_svgp`: the port's Adam is optax's, step for step, in float64
  (optax driven with the port's gradients, parameters within 1e-12);
  20 steps from the JAX-drawn minibatch indices against the JAX package's
  `fit_svgp` in float64 within 1e-5, which is all the reference itself
  holds there: its kernels accumulate `x z^T` in float32 even under x64
  (5e-7 in each kernel entry), and Adam's per-coordinate normalization
  carries that into every step (1e-6 measured); in float32, ELBO + log
  prior after 200 steps within 1e-3 relative.
The JAX side is jitted on the CPU, where its kernel matrices take the
plain jnp path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from botorch_tpu.acquisition.analytic import make_acqf as j_make_acqf
from botorch_tpu.models import approximate_gp as jag
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition.analytic import make_acqf
from botorch_tpu_torch.models import approximate_gp as tag
from _torch_threads import _one_torch_thread  # noqa: F401

N, D, M, BATCH = 96, 3, 12, 32


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = -np.sum((X - 0.4) ** 2, axis=-1) + 0.05 * rng.normal(size=n)
    return X, Y


def _indices(key, steps, batch, n):
    """The minibatch indices the JAX `fit_svgp` draws from `key`."""
    return np.array(jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, n))(
        jax.random.split(key, steps)))


@pytest.mark.parametrize("kernel,quality", [("rbf", False), ("matern52", False),
                                            ("matern52", True)])
def test_greedy_variance_reduction_picks_the_same_pivots(kernel, quality):
    X, Y = _data(1, n=200)
    ls = np.array([0.3, 0.5, 0.8])
    q = np.abs(Y) + 0.1 if quality else None
    with jax.enable_x64(True):
        Zj = np.asarray(jax.jit(
            lambda X, ls, q: jag.greedy_variance_reduction(X, ls, 24, kernel, quality_scores=q)
        )(jnp.asarray(X), jnp.asarray(ls), None if q is None else jnp.asarray(q)))
    Zt = tag.greedy_variance_reduction(torch.tensor(X), torch.tensor(ls), 24, kernel,
                                       quality_scores=None if q is None else torch.tensor(q))
    np.testing.assert_array_equal(Zt.numpy(), Zj)
    assert len({tuple(r) for r in Zt.tolist()}) == 24  # no pivot taken twice


def test_make_svgp_matches_reference():
    X, Y = _data()
    jm = jag.make_svgp(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32), num_inducing=M)
    tm = tag.make_svgp(X.astype(np.float32), Y.astype(np.float32), num_inducing=M,
                       device="cpu")
    for f in tag.SVGP.FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (tm.kernel, tm.learn_inducing) == (jm.kernel, jm.learn_inducing) == ("matern52", True)
    assert tm.train_chol() is None and tm.batch_shape == () and tm.num_outputs == 1


def _carried_over(dtype=np.float32, seed=2):
    """A JAX SVGP with random variational and kernel parameters, and the
    port's copy of it."""
    X, Y = _data()
    rng = np.random.default_rng(seed)
    jm = jag.make_svgp(jnp.asarray(X, dtype), jnp.asarray(Y, dtype), num_inducing=M)
    params = dict(
        nu_mean=0.5 * rng.normal(size=M),
        raw_L=np.tril(0.1 * rng.normal(size=(M, M))) + 0.3 * np.eye(M),
        mean_const=np.asarray(0.2),
        raw_lengthscale=np.log([0.4, 0.7, 1.1]),
        raw_outputscale=np.asarray(0.3),
        raw_noise=np.asarray(np.log(0.05)),
        Z=np.asarray(jm.Z) + 0.02 * rng.normal(size=(M, D)),
    )
    jm = jm.replace(**{k: jnp.asarray(v, dtype) for k, v in params.items()})
    arrays = {f: np.asarray(getattr(jm, f)) for f in tag.SVGP.FIELDS}
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return jm, convert.svgp_from_numpy(arrays, dtype=tdt)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def test_svgp_posterior_elbo_and_log_prior_match_reference():
    jm, tm = _carried_over()
    Xq = np.random.default_rng(3).uniform(size=(7, D)).astype(np.float32)
    idx = _indices(jax.random.PRNGKey(0), 1, BATCH, N)[0]

    @jax.jit
    def reference(jm, Xq, idx):
        posts = [jm.posterior(Xq, observation_noise=o) for o in (False, True)]
        return ([(p.mean, p.cov) for p in posts], jm.elbo(), jm.elbo(idx), jm.log_prior())

    posts_j, elbo_j, elbo_b_j, lp_j = reference(jm, jnp.asarray(Xq), jnp.asarray(idx))
    for o, (mean_j, cov_j) in zip((False, True), posts_j):
        post = tm.posterior(torch.tensor(Xq), observation_noise=o)
        assert post.mean.shape == (7, 1) and post.cov.shape == (1, 7, 7)
        assert _rel(post.mean, mean_j) < 1e-5 and _rel(post.cov, cov_j) < 1e-5
    assert _rel(tm.elbo(), elbo_j) < 1e-5
    assert _rel(tm.elbo(torch.tensor(idx)), elbo_b_j) < 1e-5
    assert _rel(tm.log_prior(), lp_j) < 1e-5
    # a t-batch of candidate sets: each set's posterior is the unbatched one
    Xb = torch.tensor(Xq).reshape(7, 1, D)
    post_b = tm.posterior(Xb)
    assert post_b.mean.shape == (7, 1, 1) and post_b.cov.shape == (7, 1, 1, 1)
    torch.testing.assert_close(post_b.variance[:, 0, 0], tm.posterior(torch.tensor(Xq)).variance[:, 0])


def test_fit_loss_gradient_matches_reference():
    """The gradient `fit_svgp` steps on, against `jax.grad` of the JAX
    package's loss, in every trained field."""
    jm, tm = _carried_over()
    fields = tag.SVGP.PARAMS + ("Z",)
    idx = _indices(jax.random.PRNGKey(1), 1, BATCH, N)[0]

    @jax.jit
    def reference(params, idx):
        return jax.grad(lambda p: -(jm.replace(**p).elbo(idx) + jm.replace(**p).log_prior()))(
            params)

    gj = reference({f: getattr(jm, f) for f in fields}, jnp.asarray(idx))
    vals = {f: getattr(tm, f).clone().requires_grad_(True) for f in fields}
    m = tm.replace(**vals)
    grads = torch.autograd.grad(-(m.elbo(torch.tensor(idx)) + m.log_prior()),
                                [vals[f] for f in fields])
    for f, g in zip(fields, grads):
        ref = np.asarray(gj[f])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=f)


def test_analytic_logei_on_svgp_matches_reference():
    jm, tm = _carried_over()
    Xc = np.random.default_rng(4).uniform(size=(16, 1, D)).astype(np.float32)
    best_f = float(np.max(np.asarray(jm.Y_loc)))
    jacq = j_make_acqf("LogEI", jm, best_f=best_f)
    vj = np.asarray(jax.jit(jax.vmap(jacq))(jnp.asarray(Xc)))
    vt = make_acqf("LogEI", tm, best_f=best_f)(torch.tensor(Xc))
    assert vt.shape == (16,)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5, atol=1e-5)


def test_expected_improvement_quality_and_improvement_reduction():
    """float64; the scores within 1e-5 relative (the reference's kernels
    accumulate `x z^T` in float32 under x64), the pivots equal."""
    with jax.enable_x64(True):
        jm, tm = _carried_over(np.float64)
        X = np.asarray(jm.X)
        qj, Zj = (np.asarray(a) for a in jax.jit(lambda jm, X: (
            jag.expected_improvement_quality(jm, X),
            jag.greedy_improvement_reduction(jm, X, jnp.full((D,), 0.5), 10, kernel="matern52"),
        ))(jm, jnp.asarray(X)))
    assert tm.X.dtype == torch.float64
    qt = tag.expected_improvement_quality(tm, torch.tensor(X))
    np.testing.assert_allclose(qt.numpy(), qj, rtol=1e-5, atol=1e-12)
    Zt = tag.greedy_improvement_reduction(tm, torch.tensor(X), torch.full((D,), 0.5,
                                          dtype=torch.float64), 10, kernel="matern52")
    np.testing.assert_array_equal(Zt.numpy(), Zj)
    with pytest.raises(ValueError):
        tag.expected_improvement_quality(tm, torch.tensor(X)[None].expand(2, -1, -1))


def test_adam_is_optax_adam_step_for_step():
    """float64: optax.adam driven with the port's own gradients lands
    where `fit_svgp` does, within 1e-12, after 20 steps."""
    with jax.enable_x64(True):
        _, tm = _carried_over(np.float64)
    steps, lr = 20, 0.05
    idx = _indices(jax.random.PRNGKey(5), steps, BATCH, N)
    fields = tag.SVGP.PARAMS + ("Z",)
    shapes = [getattr(tm, f).shape for f in fields]
    sizes = [int(np.prod(s)) for s in shapes]

    def grad(flat, i):
        v = torch.tensor(flat, requires_grad=True)
        parts = dict(zip(fields, (p.reshape(s) for p, s in zip(v.split(sizes), shapes))))
        m = tm.replace(**parts)
        (g,) = torch.autograd.grad(-(m.elbo(torch.tensor(idx[i])) + m.log_prior()), v)
        return g.numpy()

    with jax.enable_x64(True):
        tx = optax.adam(lr)
        params = jnp.asarray(np.concatenate([getattr(tm, f).numpy().ravel() for f in fields]))
        opt = tx.init(params)
        for i in range(steps):
            upd, opt = tx.update(jnp.asarray(grad(np.asarray(params), i)), opt, params)
            params = optax.apply_updates(params, upd)
        ref = np.asarray(params)
    fit = tag.fit_svgp(tm, steps=steps, batch_size=BATCH, lr=lr, batch_indices=idx,
                       device="cpu")
    got = np.concatenate([getattr(fit, f).numpy().ravel() for f in fields])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.abs(got - np.concatenate([getattr(tm, f).numpy().ravel() for f in fields])).max() > 0.1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_svgp_matches_reference(dtype):
    """float64: 20 steps from the JAX-drawn indices, every trained field
    within 1e-5. float32: ELBO + log prior after 200 steps within 1e-3
    relative."""
    X, Y = _data(6)
    steps, batch = (20, BATCH) if dtype == "float64" else (200, 64)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        jm = jag.make_svgp(jnp.asarray(X, jdt), jnp.asarray(Y, jdt), num_inducing=M)
        idx = _indices(key, steps, batch, N)
        jf = jag.fit_svgp(jm, key, steps=steps, batch_size=batch)
        obj_j = float(jax.jit(lambda m: m.elbo() + m.log_prior())(jf))
        arrays = {f: np.asarray(getattr(jm, f)) for f in tag.SVGP.FIELDS}
        fitted_j = {f: np.asarray(getattr(jf, f)) for f in tag.SVGP.PARAMS + ("Z",)}
    tm = convert.svgp_from_numpy(arrays, dtype=getattr(torch, dtype))
    tf = tag.fit_svgp(tm, steps=steps, batch_size=batch, batch_indices=idx, device="cpu")
    if dtype == "float64":
        for f, ref in fitted_j.items():
            np.testing.assert_allclose(getattr(tf, f).numpy(), ref, rtol=0, atol=1e-5, err_msg=f)
    obj_t = float(tf.elbo() + tf.log_prior())
    assert abs(obj_t - obj_j) <= 1e-3 * abs(obj_j)
    assert obj_t > float(tm.elbo() + tm.log_prior())  # the fit improved its objective
    back = convert.svgp_to_numpy(tf)
    assert set(back) == set(tag.SVGP.FIELDS) and back["Z"].shape == (M, D)


def test_fit_svgp_draws_minibatches_from_its_generator():
    X, Y = _data(8)
    tm = tag.make_svgp(X, Y, num_inducing=8, device="cpu")
    fits = [tag.fit_svgp(tm, torch.Generator().manual_seed(s), steps=5, batch_size=16,
                         device="cpu") for s in (0, 0, 1)]
    assert torch.equal(fits[0].nu_mean, fits[1].nu_mean)
    assert not torch.equal(fits[0].nu_mean, fits[2].nu_mean)
    with pytest.raises(ValueError, match="batch_indices"):
        tag.fit_svgp(tm, steps=5, batch_size=16, batch_indices=np.zeros((4, 16)), device="cpu")
    with pytest.raises(ValueError, match="batch_indices"):
        tag.fit_svgp(tm, steps=1, batch_size=16, batch_indices=np.full((1, 16), N),
                     device="cpu")
    # the whole data set as the batch: no minibatch, no generator needed
    full = tag.fit_svgp(tm, steps=2, batch_size=N, device="cpu")
    assert torch.isfinite(full.elbo())
