"""Port parity for `acquisition/monte_carlo.py` against botorch_tpu on the CPU.

Both packages get one padded GP (capacity 16, 12 real rows, d = 3) and the
same qMC base samples (drawn by the JAX package and passed in). The port
evaluates a t-batch `X (b, q, d)` where the reference maps one candidate
set with `jax.vmap`. Tolerances: values within 1e-4 relative (+1e-5),
gradients within 3e-3 of their largest entry. Both sides sample a float32
joint posterior over up to 20 points through a jittered Cholesky factor,
whose rounding (~1e-6 of the covariance, amplified by its conditioning)
reaches the samples; log-EI deep in the tail divides by tau = 1e-6 and a
gradient is a difference of such terms (cf. test_torch_analytic.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.models import gp as jgp
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import monte_carlo as tmc
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.settings import make_generator
from _torch_threads import _one_torch_thread  # noqa: F401


CAP, NV, D, NMC = 16, 12, 3, 32


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    X = np.zeros((CAP, D), np.float32)
    X[:NV] = rng.uniform(size=(NV, D))
    Y = np.zeros(CAP, np.float32)
    Y[:NV] = np.sin(5 * X[:NV, 0]) + X[:NV, 1] ** 2 - X[:NV, 2]
    mask = np.arange(CAP) < NV
    pn = {"mean": np.array([0.1], np.float32),
          "raw_lengthscale": np.log(np.array([[0.3, 0.5, 0.4]], np.float32)),
          "raw_outputscale": np.zeros(1, np.float32),
          "raw_noise": np.log(np.array([1e-2], np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None], mask=jnp.asarray(mask),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y[:, None], mask=mask, device="cpu",
                     params=convert.gp_params_from_numpy(pn))
    return jm, tm, X, Y, mask


def _below(threshold):
    """Constraint `y <= threshold` on the first output (both packages)."""
    return lambda s: s[..., 0] - threshold


# name, class name, q, with baseline, constraints, pending points
CASES = [
    ("qEI", "qExpectedImprovement", 2, False, (), 0),
    ("qEI-constrained", "qExpectedImprovement", 2, False, (_below(0.8),), 0),
    ("qLogEI", "qLogExpectedImprovement", 4, False, (), 0),
    ("qPI", "qProbabilityOfImprovement", 2, False, (), 0),
    ("qSimpleRegret", "qSimpleRegret", 4, False, (), 0),
    ("qUCB", "qUpperConfidenceBound", 2, False, (), 0),
    ("qNEI", "qNoisyExpectedImprovement", 4, True, (), 0),
    ("qLogNEI", "qLogNoisyExpectedImprovement", 4, True, (), 0),
    ("qLogNEI-constrained", "qLogNoisyExpectedImprovement", 2, True, (_below(0.8),), 0),
    ("qLogNEI-pending", "qLogNoisyExpectedImprovement", 2, True, (), 2),
]


def _pair(models, cls_name, q, baseline, constraints, n_pending, seed=3):
    """The same acquisition in both packages, with the JAX package's base
    samples."""
    jm, tm, X, Y, mask = models
    q_total = q + n_pending + (CAP if baseline else 0)
    base = np.asarray(jmc._draw_base_samples(q_total, 1, NMC, seed))
    kw_j, kw_t = {}, {}
    if cls_name in ("qExpectedImprovement", "qLogExpectedImprovement",
                    "qProbabilityOfImprovement"):
        kw_j["best_f"] = kw_t["best_f"] = float(Y[mask].max())
    if cls_name == "qUpperConfidenceBound":
        kw_j["beta"] = kw_t["beta"] = 2.0
    if baseline:
        kw_j.update(X_baseline=jnp.asarray(X), baseline_mask=jnp.asarray(mask))
        kw_t.update(X_baseline=torch.tensor(X), baseline_mask=torch.tensor(mask))
    if n_pending:
        P = np.random.default_rng(9).uniform(size=(n_pending, D)).astype(np.float32)
        kw_j["X_pending"], kw_t["X_pending"] = jnp.asarray(P), torch.tensor(P)
    aj = getattr(jmc, cls_name)(model=jm, cache=jm.train_chol(), base_samples=jnp.asarray(base),
                                constraints=constraints, **kw_j)
    at = getattr(tmc, cls_name)(model=tm, cache=tm.train_chol(), base_samples=torch.tensor(base),
                                constraints=constraints, **kw_t)
    return aj, at


def _candidates(q, b=8, seed=1):
    return np.random.default_rng(seed).uniform(size=(b, q, D)).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_values_and_grads_against_reference(models, case):
    _, cls_name, q, baseline, constraints, n_pending = case
    aj, at = _pair(models, cls_name, q, baseline, constraints, n_pending)
    Xq = _candidates(q)
    vj, gj = jax.jit(jax.vmap(jax.value_and_grad(aj)))(jnp.asarray(Xq))
    Xt = torch.tensor(Xq, requires_grad=True)
    vt = at(Xt)
    (gt,) = torch.autograd.grad(vt.sum(), Xt)
    assert vt.shape == (8,)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=1e-4, atol=1e-5)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=3e-3 * scale + 1e-7)


def test_a_candidate_set_does_not_see_the_rest_of_the_batch(models):
    """A t-batch element's value is its value alone, also next to a set
    whose joint covariance needs a high jitter rung (candidates on the
    baseline points) and padded rows that leave some samples without a
    finite best: nothing reduces or escalates across the batch."""
    _, _, X, _, _ = models
    _, at = _pair(models, "qLogNoisyExpectedImprovement", 4, True, (), 0)
    Xq = _candidates(4, b=5)
    Xq[2] = X[:4]  # the candidates coincide with real baseline rows
    batched = at(torch.tensor(Xq))
    alone = torch.cat([at(torch.tensor(Xq[i:i + 1])) for i in range(5)])
    torch.testing.assert_close(batched, alone, rtol=1e-6, atol=1e-6)
    # and unbatched `(q, d)` input gives a scalar, as the reference's call does
    assert at(torch.tensor(Xq[0])).shape == ()


def test_make_mc_acqf_matches_reference(models):
    jm, tm, X, _, mask = models
    aj = jmc.make_mc_acqf(jmc.qLogNoisyExpectedImprovement, jm, q=2, num_samples=NMC, seed=5,
                          X_baseline=jnp.asarray(X), baseline_mask=jnp.asarray(mask))
    at = tmc.make_mc_acqf(tmc.qLogNoisyExpectedImprovement, tm, q=2, num_samples=NMC, seed=5,
                          X_baseline=torch.tensor(X), baseline_mask=torch.tensor(mask))
    np.testing.assert_allclose(at.base_samples.numpy(), np.asarray(aj.base_samples),
                               rtol=1e-6, atol=1e-6)
    Xq = _candidates(2)
    np.testing.assert_allclose(at(torch.tensor(Xq)).numpy(),
                               np.asarray(jax.jit(jax.vmap(aj))(jnp.asarray(Xq))),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="item 19"):
        tmc.make_mc_acqf(tmc.qLogNoisyExpectedImprovement, tm, q=2, prune_baseline=True,
                         X_baseline=torch.tensor(X))


def test_linear_objective_and_feasibility_indicator():
    s = np.random.default_rng(2).normal(size=(5, 3, 2)).astype(np.float32)
    w = np.array([0.3, -1.2], np.float32)
    np.testing.assert_allclose(tmc.linear_objective(w)(torch.tensor(s)).numpy(),
                               np.asarray(jmc.linear_objective(jnp.asarray(w))(jnp.asarray(s))),
                               rtol=1e-6)
    cons = (_below(0.1), lambda y: -y[..., 1])
    for fat in (True, False):
        np.testing.assert_allclose(
            tmc.smoothed_feasibility_log_indicator(cons, torch.tensor(s), 1e-1, fat=fat).numpy(),
            np.asarray(jmc.smoothed_feasibility_log_indicator(cons, jnp.asarray(s), 1e-1, fat=fat)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q_total,m,n", [(20, 1, 32), (3, 2, 16)])
def test_fresh_base_samples_with_the_reference_words(q_total, m, n):
    """With JAX's 32-bit words injected, the shifted Sobol bits are the
    reference's exactly and the normals agree within float32 ndtri rounding
    (1e-6 relative, 2e-6 absolute at |z| up to 5.6)."""
    from botorch_tpu.sampling.sobol import draw_sobol_bits as j_bits
    from botorch_tpu.sampling.sobol import sobol_table as j_table
    from botorch_tpu_torch.sampling.sobol import draw_sobol_bits, sobol_table

    key = jax.random.PRNGKey(4)
    words = np.asarray(jax.random.bits(key, (q_total * m,), dtype=jnp.uint32))
    ref = np.asarray(jmc.draw_fresh_base_samples(q_total, m, n, key, seed=17))
    got = tmc.base_samples_from_words(q_total, m, n, torch.tensor(words.astype(np.int64)), seed=17)
    sv, sh = sobol_table(q_total * m, seed=17)
    sv_j, sh_j = j_table(q_total * m, seed=17)
    np.testing.assert_array_equal(
        draw_sobol_bits(sv, sh ^ torch.tensor(words.astype(np.int64)), n).numpy(),
        np.asarray(j_bits(sv_j, sh_j ^ jnp.asarray(words), n)).astype(np.int64))
    assert got.shape == (n, q_total, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=2e-6)
    # the port's own draw: fresh words from the generator, same seeded engine
    a = tmc.draw_fresh_base_samples(q_total, m, n, make_generator(0, "cpu"), seed=17)
    b = tmc.draw_fresh_base_samples(q_total, m, n, make_generator(0, "cpu"), seed=17)
    c = tmc.draw_fresh_base_samples(q_total, m, n, make_generator(1, "cpu"), seed=17)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
