"""Port parity for `sampling/pathwise.py` and `generation/sampling.py`
against botorch_tpu on the CPU, with the JAX package's own draws passed
in (its key splits replayed by `_jax_path_draws`), at tiny sizes (n <= 24,
M <= 10, d <= 3, L <= 64 features).

* `MatheronPath` (exact GP: rbf and matern52, with and without a padding
  mask, with an outputscale) and `SVGPMatheronPath` values within 1e-4 of
  their largest entry in float32: each goes through a float32 Cholesky
  solve of a covariance with condition number ~1e3-1e4.
* `max_posterior_sampling`, pathwise and joint, and
  `constrained_max_posterior_sampling`: the same candidates wherever the
  top two sampled values of a draw are further apart than the values'
  tolerance (the float32 argmax of a near-tie may flip between packages),
  and always in float64.
* `boltzmann_sampling` with and without replacement, over values with
  -inf and NaN entries, from the same Gumbel noise: the same picks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.generation import sampling as jgs
from botorch_tpu.models import approximate_gp as jag
from botorch_tpu.models import gp as jgp
from botorch_tpu.sampling import pathwise as jpw
from botorch_tpu_torch import convert
from botorch_tpu_torch.generation import sampling as tgs
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.models.approximate_gp import SVGP
from botorch_tpu_torch.sampling import pathwise as tpw
from _torch_threads import _one_torch_thread  # noqa: F401

N, D, L, P = 16, 3, 64, 3
NU = {"matern52": 2.5}


def _jax_path_draws(key, kernel, P, L, d, k):
    """The draws the JAX `draw_matheron_paths` takes from `key`: its key
    splits replayed, as `PathDraws` fields (numpy)."""
    k_sw, k_th, k_eps = jax.random.split(key, 3)
    k_w, k_b, k_u = jax.random.split(k_sw, 3)
    z = jax.random.normal(k_w, (L, d))
    b = jax.random.uniform(k_b, (L,), maxval=2.0 * math.pi)
    chi2 = 2.0 * jax.random.gamma(k_u, NU[kernel], (L, 1)) if kernel in NU else None
    theta = jax.random.normal(k_th, (P, L))
    eps = jax.random.normal(k_eps, (P, k))
    return z, b, chi2, theta, eps


def _to_draws(arrays, dtype=torch.float32):
    return tpw.PathDraws(*(None if a is None else torch.tensor(np.array(a), dtype=dtype)
                           for a in arrays))


def _gp_pair(kernel, padded, use_outputscale=False, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    cap = N + 6 if padded else N
    X = np.zeros((cap, D)); Y = np.zeros(cap)
    X[:N] = rng.uniform(size=(N, D))
    Y[:N] = np.sin(5 * X[:N, 0]) + X[:N, 1] ** 2 + 0.05 * rng.normal(size=N)
    mask = np.arange(cap) < N if padded else None
    pn = {"mean": np.array([0.1]), "raw_lengthscale": np.log([[0.3, 0.5, 0.8]]),
          "raw_outputscale": np.array([np.log(1.7)]), "raw_noise": np.array([np.log(0.01)])}
    pn = {k: v.astype(dtype) for k, v in pn.items()}
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jm = jgp.make_gp(jnp.asarray(X, jdt), jnp.asarray(Y, jdt)[:, None], kernel=kernel,
                     use_outputscale=use_outputscale,
                     mask=None if mask is None else jnp.asarray(mask),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tm = tgp.make_gp(X, Y[:, None], kernel=kernel, use_outputscale=use_outputscale, mask=mask,
                     device="cpu", dtype=tdt, params=convert.gp_params_from_numpy(pn, dtype=tdt))
    return jm, tm


def _svgp_pair(seed=0, M=10):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(40, D)).astype(np.float32)
    Y = (-np.sum((X - 0.4) ** 2, axis=-1)).astype(np.float32)
    jm = jag.make_svgp(jnp.asarray(X), jnp.asarray(Y), num_inducing=M)
    jm = jm.replace(
        nu_mean=jnp.asarray(rng.normal(size=M), jnp.float32),
        raw_L=jnp.asarray(np.tril(0.1 * rng.normal(size=(M, M))) + 0.2 * np.eye(M), jnp.float32),
        raw_lengthscale=jnp.asarray(np.log([0.4, 0.6, 0.9]), jnp.float32),
        raw_outputscale=jnp.asarray(0.2, jnp.float32),
    )
    return jm, convert.svgp_from_numpy({f: np.asarray(getattr(jm, f)) for f in SVGP.FIELDS})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


@pytest.mark.parametrize("kernel,padded,outputscale", [
    ("rbf", False, False), ("rbf", True, False), ("matern52", True, True)])
def test_matheron_path_values_match_reference(kernel, padded, outputscale):
    jm, tm = _gp_pair(kernel, padded, outputscale)
    Xc = np.random.default_rng(1).uniform(size=(30, D)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def reference(jm, key, Xc):
        path = jpw.draw_matheron_paths(jm, key, P, L)
        draws = _jax_path_draws(key, kernel, P, L, D, jm.num_train)
        return path(Xc), path.prior(Xc), draws

    vj, prior_j, draws = reference(jm, key, jnp.asarray(Xc))
    path = tpw.draw_matheron_paths(tm, num_paths=P, num_features=L, draws=_to_draws(draws))
    vt = path(torch.tensor(Xc))
    assert vt.shape == (P, 30)
    assert _rel(path.prior(torch.tensor(Xc)), prior_j) < 1e-5
    assert _rel(vt, vj) < 1e-4
    # one point is a one-row batch, as `jnp.atleast_2d` makes it
    assert path(torch.tensor(Xc[0])).shape == (P, 1)


def test_svgp_matheron_path_values_match_reference():
    jm, tm = _svgp_pair()
    Xc = np.random.default_rng(3).uniform(size=(30, D)).astype(np.float32)
    key = jax.random.PRNGKey(4)

    @jax.jit
    def reference(jm, key, Xc):
        path = jpw.draw_matheron_paths(jm, key, P, L)
        return path(Xc), _jax_path_draws(key, "matern52", P, L, D, jm.num_inducing)

    vj, draws = reference(jm, key, jnp.asarray(Xc))
    vt = tpw.draw_matheron_paths(tm, num_paths=P, num_features=L, draws=_to_draws(draws))(
        torch.tensor(Xc))
    assert vt.shape == (P, 30)
    assert _rel(vt, vj) < 1e-4


def test_port_draws_and_refusals():
    jm, tm = _gp_pair("matern52", False)
    g = torch.Generator().manual_seed(0)
    dr = tpw.draw_path_draws(g, "matern52", D, 2, 4096, N)
    assert dr.z.shape == (4096, D) and dr.chi2.shape == (4096, 1) and dr.eps.shape == (2, N)
    # chi-square with 2 nu = 5 degrees of freedom: mean 5, variance 10
    assert abs(float(dr.chi2.mean()) - 5.0) < 0.2 and float(dr.b.min()) >= 0
    assert float(dr.b.max()) < 2 * math.pi
    assert tpw.draw_path_draws(g, "rbf", D, 2, 8, N).chi2 is None
    with pytest.raises(ValueError, match="Generator"):
        tpw.draw_matheron_paths(tm, None, 2, 8)
    with pytest.raises(NotImplementedError, match="item 18"):
        tpw.draw_matheron_paths(object(), g, 2, 8)
    fb = tm.replace(params=tm.params.map(lambda t: t.expand(2, *t.shape)), _is_fully_bayesian=True)
    with pytest.raises(ValueError):
        tpw.draw_matheron_paths(fb, g, 2, 8)
    with pytest.raises(NotImplementedError):
        tgs.make_pathwise_thompson_sampling(fb, g)
    x = torch.rand(5, D, generator=g)
    assert tpw.get_gp_samples(tm, g, n_samples=3, num_rff_features=16)(x).shape == (3, 5, 1)
    assert tpw.get_matheron_path_model(tm, g, num_features=16)(x).shape == (5,)
    ts = tgs.make_pathwise_thompson_sampling(tm, g, num_features=16)
    # (b, q, d) -> (b,): the q-sum of the one path; (q, d) -> ()
    Xq = torch.rand(4, 2, D, generator=g)
    torch.testing.assert_close(ts(Xq), ts.paths(Xq)[0].sum(-1))
    assert ts(Xq[0]).shape == ()


def _margin_ok(vals, tol):
    """Draws whose best value leads the runner-up by more than `tol`."""
    top2 = np.sort(np.asarray(vals, np.float64), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_max_posterior_sampling_pathwise_matches_reference(dtype):
    with jax.enable_x64(dtype == "float64"):
        jm, tm = _gp_pair("rbf", True, dtype=getattr(np, dtype))
        Xc = np.random.default_rng(5).uniform(size=(200, D)).astype(dtype)
        key = jax.random.PRNGKey(6)

        @jax.jit
        def reference(jm, key, Xc):
            path = jpw.draw_matheron_paths(jm, key, 4, L)
            return (jgs.max_posterior_sampling(jm, Xc, key, num_samples=4, num_features=L),
                    path(Xc), _jax_path_draws(key, "rbf", 4, L, D, jm.num_train))

        cj, vj, draws = reference(jm, key, jnp.asarray(Xc))
        cj, vj = np.asarray(cj), np.asarray(vj)
    tdt = getattr(torch, dtype)
    ct = tgs.max_posterior_sampling(tm, torch.tensor(Xc), num_samples=4, num_features=L,
                                    draws=_to_draws(draws, tdt))
    assert ct.shape == (4, D) and ct.dtype == tdt
    tol = 1e-4 * max(1.0, np.abs(vj).max()) if dtype == "float32" else 0.0
    ok = _margin_ok(vj, tol)
    assert ok.sum() >= 3
    np.testing.assert_array_equal(ct.numpy()[ok], cj[ok])
    # minimizing picks each path's argmin
    cmin = tgs.max_posterior_sampling(tm, torch.tensor(Xc), num_samples=4, num_features=L,
                                      maximize=False, draws=_to_draws(draws, tdt))
    ok_min = _margin_ok(-vj, tol)
    np.testing.assert_array_equal(cmin.numpy()[ok_min], Xc[np.argmin(vj, -1)][ok_min])


def test_max_posterior_sampling_joint_matches_reference():
    jm, tm = _gp_pair("matern52", False)
    Xc = np.random.default_rng(7).uniform(size=(40, D)).astype(np.float32)
    key = jax.random.PRNGKey(8)

    @jax.jit
    def reference(jm, key, Xc):
        post = jm.posterior(Xc)
        base = jax.random.normal(key, (5, 40, 1))
        return (jgs.max_posterior_sampling(jm, Xc, key, num_samples=5, method="joint"),
                post.rsample_from_base_samples(base)[..., 0], base)

    cj, vj, base = (np.asarray(a) for a in reference(jm, key, jnp.asarray(Xc)))
    ct = tgs.max_posterior_sampling(tm, torch.tensor(Xc), num_samples=5, method="joint",
                                    draws=torch.tensor(base))
    ok = _margin_ok(vj, 1e-4 * max(1.0, np.abs(vj).max()))
    assert ok.sum() >= 4
    np.testing.assert_array_equal(ct.numpy()[ok], cj[ok])


def test_constrained_max_posterior_sampling_matches_reference():
    jm, tm = _gp_pair("rbf", False)
    jc, tc = _gp_pair("matern52", False, seed=3)
    Xc = np.random.default_rng(9).uniform(size=(40, D)).astype(np.float32)
    key = jax.random.PRNGKey(10)

    @jax.jit
    def reference(jm, jc, key, Xc):
        k_obj, k_con = jax.random.split(key)
        return (jgs.constrained_max_posterior_sampling(jm, jc, Xc, key, num_samples=6),
                jax.random.normal(k_obj, (6, 40, 1)), jax.random.normal(k_con, (6, 40, 1)))

    cj, ob, cb = (np.asarray(a) for a in reference(jm, jc, key, jnp.asarray(Xc)))
    ct = tgs.constrained_max_posterior_sampling(tm, tc, torch.tensor(Xc), num_samples=6,
                                                base_samples=(torch.tensor(ob), torch.tensor(cb)))
    assert ct.shape == (6, D)
    np.testing.assert_array_equal(ct.numpy(), cj)


@pytest.mark.parametrize("replacement", [True, False])
def test_boltzmann_sampling_matches_reference(replacement):
    rng = np.random.default_rng(11)
    vals = rng.normal(size=50).astype(np.float32)
    vals[[3, 17]] = -np.inf
    vals[29] = np.nan
    Xc = rng.uniform(size=(50, D)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    s = 6

    @jax.jit
    def reference(vals, Xc, key):
        if replacement:
            g = jax.random.gumbel(key, (s, 50))
        else:
            g = -jnp.log(-jnp.log(jax.random.uniform(key, (50,), minval=1e-20)))
        return (jgs.boltzmann_sampling(vals, Xc, key, num_samples=s, eta=2.0,
                                       replacement=replacement), g)

    cj, g = (np.asarray(a) for a in reference(jnp.asarray(vals), jnp.asarray(Xc), key))
    ct = tgs.boltzmann_sampling(torch.tensor(vals), torch.tensor(Xc), num_samples=s, eta=2.0,
                                replacement=replacement, gumbel=torch.tensor(g))
    np.testing.assert_array_equal(ct.numpy(), cj)
    bad = {tuple(Xc[i]) for i in (3, 17, 29)}
    assert not any(tuple(r) in bad for r in ct.tolist())
    # the port's own noise: never a non-finite value, no repeat without replacement
    picks = tgs.boltzmann_sampling(torch.tensor(vals), torch.arange(50.0)[:, None],
                                   torch.Generator().manual_seed(0), num_samples=s,
                                   replacement=replacement)[:, 0].long().tolist()
    assert not {3, 17, 29} & set(picks)
    if not replacement:
        assert len(set(picks)) == s
