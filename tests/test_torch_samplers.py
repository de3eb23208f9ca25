"""Port parity for the sampling surface of the MC slice against botorch_tpu
on the CPU: `posteriors/gaussian.py` (scale_tril, rsample, quantile,
density, scalarize_posterior), `sampling/sobol.draw_sobol_normal_samples`,
`sampling/qmc.py` and `sampling/samplers.py`.

The Sobol points are bit-exact in both packages (test_torch_sobol.py), so
qMC normals differ only by float32 `ndtri` rounding: within 1e-6 relative
and 2e-6 absolute (|z| up to 5.6). Posterior quantities go through a
float32 Cholesky factor of a covariance with condition number < 100:
within 1e-5. Draws from random generators (i.i.d. and stochastic samplers,
`rsample`) cannot match JAX's draws, so they are held to shapes, seeding
and moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.posteriors import gaussian as jg
from botorch_tpu.sampling import qmc as jq
from botorch_tpu.sampling import samplers as js
from botorch_tpu.sampling.sobol import draw_sobol_normal_samples as j_normal
from botorch_tpu_torch.posteriors import gaussian as tg
from botorch_tpu_torch.sampling import qmc as tq
from botorch_tpu_torch.sampling import samplers as ts
from botorch_tpu_torch.sampling.sobol import draw_sobol_normal_samples as t_normal
from botorch_tpu_torch.settings import make_generator
from _torch_threads import _one_torch_thread  # noqa: F401


NORMAL_TOL = dict(rtol=1e-6, atol=2e-6)


def _posterior_arrays(batch=(3,), q=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(*batch, q, m)).astype(np.float32)
    A = rng.normal(size=(*batch, m, q, q))
    cov = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(q)).astype(np.float32)
    return mean, cov


def _both(mean, cov):
    return (jg.GaussianPosterior(mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
            tg.GaussianPosterior(mean=torch.tensor(mean), cov=torch.tensor(cov)))


@pytest.mark.parametrize("d,n,seed", [(1, 16, 0), (6, 128, 17), (80, 32, 3)])
def test_sobol_normal_samples(d, n, seed):
    z = t_normal(d, n, seed=seed, device="cpu")
    assert z.shape == (n, d) and z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(j_normal(d, n, seed=seed)), **NORMAL_TOL)


def test_scale_tril_and_rsample_from_base_samples():
    """The t-batch posterior against the reference mapped over the batch."""
    mean, cov = _posterior_arrays()
    pj, pt = _both(mean, cov)
    L_j = jax.vmap(lambda c: jg.GaussianPosterior(mean=jnp.zeros((4, 2)), cov=c).scale_tril)(
        jnp.asarray(cov))
    np.testing.assert_allclose(pt.scale_tril.numpy(), np.asarray(L_j), rtol=1e-5, atol=1e-5)
    assert pt.base_sample_shape == (3, 4, 2) == tuple(pj.base_sample_shape)
    base = np.random.default_rng(1).normal(size=(5, 3, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(pt.rsample_from_base_samples(torch.tensor(base)).numpy(),
                               np.asarray(pj.rsample_from_base_samples(jnp.asarray(base))),
                               rtol=1e-5, atol=1e-5)
    # float32 base samples are cast to a float64 posterior's dtype
    p64 = tg.GaussianPosterior(mean=torch.tensor(mean, dtype=torch.float64),
                               cov=torch.tensor(cov, dtype=torch.float64))
    assert p64.rsample_from_base_samples(torch.tensor(base)).dtype == torch.float64


def test_rsample_shapes_seeding_and_moments():
    mean, cov = _posterior_arrays(batch=(), q=3, m=1)
    _, pt = _both(mean, cov)
    draws = pt.rsample(make_generator(0, "cpu"), (20000,))
    assert draws.shape == (20000, 3, 1)
    again = pt.rsample(make_generator(0, "cpu"), (20000,))
    assert torch.equal(draws, again)
    # 20,000 draws: standard errors ~0.7% of the scale
    np.testing.assert_allclose(draws.mean(0).numpy(), mean, atol=0.05)
    emp = np.cov(draws[..., 0].numpy().T)
    np.testing.assert_allclose(emp, cov[0], atol=0.05 * np.abs(cov).max())


@pytest.mark.parametrize("value", [0.3, [0.05, 0.5, 0.9]])
def test_quantile_and_density(value):
    mean, cov = _posterior_arrays()
    pj, pt = _both(mean, cov)
    np.testing.assert_allclose(pt.quantile(value).numpy(), np.asarray(pj.quantile(jnp.asarray(value))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pt.density(value).numpy(), np.asarray(pj.density(jnp.asarray(value))),
                               rtol=1e-5, atol=1e-6)


def test_scalarize_posterior():
    mean, cov = _posterior_arrays()
    pj, pt = _both(mean, cov)
    w = np.array([0.7, -1.5], np.float32)
    sj = jg.scalarize_posterior(pj, jnp.asarray(w), offset=0.25)
    st = tg.scalarize_posterior(pt, w, offset=0.25)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=1e-6, atol=1e-6)


def test_qmc_engines():
    e_t, e_j = tq.NormalQMCEngine(5, seed=2, device="cpu"), jq.NormalQMCEngine(5, seed=2)
    for n in (8, 24):  # successive draws continue one sequence
        np.testing.assert_allclose(e_t.draw(n).numpy(), np.asarray(e_j.draw(n)), **NORMAL_TOL)
    mean, cov = _posterior_arrays(batch=(), q=3, m=1)
    mv_t = tq.MultivariateNormalQMCEngine(torch.tensor(mean[:, 0]), torch.tensor(cov[0]), seed=4)
    mv_j = jq.MultivariateNormalQMCEngine(jnp.asarray(mean[:, 0]), jnp.asarray(cov[0]), seed=4)
    np.testing.assert_allclose(mv_t.draw(64).numpy(), np.asarray(mv_j.draw(64)),
                               rtol=1e-5, atol=1e-5)


def test_sobol_sampler_matches_reference():
    mean, cov = _posterior_arrays()
    pj, pt = _both(mean, cov)
    s_t = ts.SobolQMCNormalSampler(sample_shape=(16,), seed=7)
    s_j = js.SobolQMCNormalSampler(sample_shape=(16,), seed=7)
    np.testing.assert_allclose(s_t.base_samples((3, 4, 2), device="cpu").numpy(),
                               np.asarray(s_j.base_samples((3, 4, 2))), **NORMAL_TOL)
    np.testing.assert_allclose(s_t(pt).numpy(), np.asarray(s_j(pj)), rtol=1e-5, atol=1e-5)


def test_random_samplers_shapes_and_seeding():
    mean, cov = _posterior_arrays()
    _, pt = _both(mean, cov)
    iid = ts.IIDNormalSampler(sample_shape=(4096,), seed=1)
    z = iid.base_samples((3, 4, 2), device="cpu")
    assert z.shape == (4096, 3, 4, 2) and torch.equal(z, iid.base_samples((3, 4, 2), device="cpu"))
    # 98,304 standard normals: mean and sd within ~5 standard errors
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert iid(pt).shape == (4096, 3, 4, 2)
    fork = ts.ForkedRNGSampler(sample_shape=(6,), seed=3)
    assert torch.equal(fork(pt), fork(pt)) and fork(pt).shape == (6, 3, 4, 2)
    stoch = ts.StochasticSampler(sample_shape=(6,))
    gen = make_generator(5, "cpu")
    a, b = stoch(pt, gen), stoch(pt, gen)
    assert a.shape == (6, 3, 4, 2) and not torch.equal(a, b)
    both = ts.ListSampler(samplers=(fork, stoch))([pt, pt])
    assert len(both) == 2 and torch.equal(both[0], fork(pt))


def test_get_sampler_choice_matches_reference():
    for q in (4, 600):  # 4 * 2 and 600 * 2 base dims, either side of the Sobol table
        mean, cov = _posterior_arrays(batch=(), q=q, m=2)
        pj, pt = _both(mean, cov)
        got = ts.get_sampler(pt, (8,), seed=1)
        ref = js.get_sampler(pj, (8,), seed=1)
        assert type(got).__name__ == type(ref).__name__
        assert got.sample_shape == (8,) and got.seed == 1
