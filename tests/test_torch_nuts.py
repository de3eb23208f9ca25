"""Port parity for `sampling/nuts.py` against botorch_tpu on the CPU.

JAX's random bits cannot be matched, so the port's transition takes its
draws as tensors and these tests rebuild them from the JAX key: per chain
the key splits into (momentum, directions, proposals), and the proposal
key is split once per uniform, in the order the JAX transition reads them
(the leaves of a subtree, then the doubling decision).

* One tree in float64 (`jax.enable_x64`) on a closed-form potential that
  both packages compute to the last bit, with a dense mass factor: tree
  depth, leaf count, divergence and accept probability equal exactly (the
  last to 1e-12), the new point within 1e-12. The reference's stats
  carry no turning flag; where they imply one (a tree that ended below
  `max_depth` without diverging turned) the port's agrees.
* One tree (depth 2, to keep the JAX compile short) in float32 on the
  SAAS potential with a padding mask, the port's side on the fit's
  closed-form gradient: the same decisions, the point within 1e-4 and the potential within 1e-5
  relative (both sides' float32 potentials are ~1e-5 from float64).
* One leapfrog on the SAAS potential (float32): within 2e-5 of the
  largest entry; dual averaging within 1e-6 relative; the warmup
  schedule exactly; the mass-matrix refresh within 1e-5.
* Lockstep chains: a chain's result equals a run of that chain alone,
  it reads exactly `uniforms_used` uniforms, and the host reads per
  transition stay below `max_depth`.
* Slow: one tree at `max_depth = 6`, and `run_nuts` end to end with every
  transition's draws rebuilt from the JAX keys (the JAX programs take
  10-30 s to compile on a CPU).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.models.fully_bayesian import make_saas_potential as j_make_saas_potential
from botorch_tpu.sampling import nuts as jn
from botorch_tpu_torch.models.fully_bayesian import make_saas_potential as t_make_saas_potential
from botorch_tpu_torch.models.fully_bayesian import (
    make_saas_potential_and_grad as t_make_saas_potential_and_grad,
)
from botorch_tpu_torch.sampling import nuts as tn
from _torch_threads import _one_torch_thread  # noqa: F401


K_QUARTIC = 5


def _quartic_parts():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(K_QUARTIC, K_QUARTIC))
    A = A @ A.T / K_QUARTIC + 0.2 * np.eye(K_QUARTIC)
    chol = np.linalg.cholesky(np.linalg.inv(A) + 0.1 * np.eye(K_QUARTIC))
    return A, chol


A_Q, CHOL_Q = _quartic_parts()


def j_quartic(z):
    return 0.5 * z @ (jnp.asarray(A_Q) @ z) + 0.05 * jnp.sum(z**4)


def t_quartic(z):
    return 0.5 * torch.sum(z * (z @ torch.tensor(A_Q, dtype=z.dtype).T), -1) + 0.05 * torch.sum(z**4, -1)


def _rebuild_one(key, k, max_depth):
    """The draws of one chain's transition, split from its key as the JAX
    transition splits them (dtype: the x64 mode's default float)."""
    k_mom, k_dirs, k_prop = jax.random.split(key, 3)
    eps = jax.random.normal(k_mom, (k,))
    dirs = jax.random.rademacher(k_dirs, (max_depth,), dtype=jnp.int32)

    def body(pk, _):
        pk, sub = jax.random.split(pk)
        return pk, jax.random.uniform(sub, (), minval=1e-38)

    _, u = jax.lax.scan(body, k_prop, None, length=tn.num_uniforms(max_depth))
    return eps, dirs, u


@functools.lru_cache(maxsize=None)
def _rebuilder(k, max_depth):
    return jax.jit(jax.vmap(lambda key: _rebuild_one(key, k, max_depth)))


def rebuild_draws(keys, k, max_depth, dtype):
    eps, dirs, u = _rebuilder(k, max_depth)(keys)
    return tn.TransitionDraws(
        torch.tensor(np.asarray(eps), dtype=dtype),
        torch.tensor(np.asarray(dirs), dtype=dtype),
        torch.tensor(np.asarray(u), dtype=dtype),
    )


def _j_safe(pg):
    def pg_safe(z):
        v, g = pg(z)
        return jnp.where(jnp.isfinite(v), v, jnp.inf), jnp.where(jnp.isfinite(g), g, 0.0)

    return pg_safe


def value_and_grad_safe(potential):
    """`z (C, k) -> (pe (C,), g (C, k))` for a potential batched over
    chains, made `safe`: the gradient is autograd's of the sum over the
    (independent) chains."""

    def pg(z):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            v = potential(zg)
            (grad,) = torch.autograd.grad(v.sum(), zg)
        return v.detach(), grad

    return tn.safe(pg)


def _j_transition(pg_safe, chol, max_depth):
    return jax.jit(jax.vmap(
        lambda z, pe, g, key, step: jn.nuts_transition(pg_safe, z, pe, g, key, (step, chol), max_depth),
        in_axes=(0, 0, 0, 0, None),
    ))


def _assert_same_tree(st_j, st_t, max_depth):
    depth = np.asarray(st_j["depth"])
    div = np.asarray(st_j["diverging"])
    np.testing.assert_array_equal(st_t["depth"].numpy(), depth)
    np.testing.assert_array_equal(st_t["num_leaves"].numpy(), np.asarray(st_j["num_leaves"]))
    np.testing.assert_array_equal(st_t["diverging"].numpy(), div)
    # a tree that stopped below max_depth without diverging turned
    turned = (depth < max_depth) & ~div
    assert st_t["turning"].numpy()[turned].all()


# ---------------------------------------------------------------------- #
def _saas_problem(n=12, d=4, n_valid=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = np.sin(6 * X[:, 0])
    Y = (Y - Y[:n_valid].mean()) / Y[:n_valid].std()
    mask = np.arange(n) < n_valid
    k = 3 + 1 + d
    return X, Y, mask, k


def _saas_starts(C, k, d, seed):
    rng = np.random.default_rng(seed)
    return 0.5 * rng.normal(size=(C, k)) + np.r_[0.0, 0.0, math.log(0.01), math.log(0.1), np.zeros(d)]


def test_warmup_schedule_matches_reference():
    for num_warmup in (0, 10, 19, 20, 21, 48, 64, 100, 128, 200, 256, 300, 512, 1000, 2048):
        assert tn._warmup_schedule(num_warmup) == jn._warmup_schedule(num_warmup), num_warmup
    assert tn._warmup_schedule(256) == [63, 113, 213, 231]
    assert tn._warmup_schedule(128) == [44, 94, 116]


def test_dual_averaging_matches_reference():
    accepts = np.random.default_rng(1).uniform(size=30).astype(np.float32)
    sj = jn.da_init(0.1)
    st = tn.da_init(0.1)
    for a in accepts:
        sj = jn.da_update(sj, jnp.float32(a), 0.8)
        st = tn.da_update(st, torch.tensor(a), 0.8)
        for fj, ft in zip(sj, st):
            np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-7)


def test_refresh_matches_reference():
    """The window's pooled moments, shrunk toward the identity, give the
    new mass factor; dual averaging restarts at the averaged step size
    (`da_init(1.0)._replace(...)` in the JAX warmup). A window whose
    covariance does not factor keeps the old factor."""
    rng = np.random.default_rng(2)
    k, C, iters = 6, 8, 5
    zs = rng.normal(size=(iters, C, k)).astype(np.float32) * rng.uniform(0.2, 2.0, size=k).astype(np.float32)
    wsum = zs.sum((0, 1))
    wsq = np.einsum("tci,tcj->ij", zs, zs)
    wn = float(iters * C)
    da = jn.da_update(jn.da_init(0.1), jnp.float32(0.6), 0.8)
    n = max(wn, 2.0)
    mean = jnp.asarray(wsum) / n
    cov = jnp.asarray(wsq) / n - jnp.outer(mean, mean)
    cov = (n / (n + 5.0)) * cov + (1e-3 * (5.0 / (n + 5.0))) * jnp.eye(k)
    chol_j = np.asarray(jnp.linalg.cholesky(cov))
    da_j = jn.da_init(1.0)._replace(
        log_eps=da.log_eps_avg, mu=jnp.log(10.0) + da.log_eps_avg, log_eps_avg=da.log_eps_avg
    )
    da_t = tn.DAState(*(torch.tensor(np.asarray(f)) for f in da))
    old = torch.eye(k) * 3.0
    da2, chol = tn._refresh(da_t, old, torch.tensor(wsum), torch.tensor(wsq), wn, True)
    np.testing.assert_allclose(chol.numpy(), chol_j, rtol=1e-5, atol=1e-6)
    for fj, ft in zip(da_j, da2):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    _, chol_diag = tn._refresh(da_t, old, torch.tensor(wsum), torch.tensor(wsq), wn, False)
    np.testing.assert_allclose(chol_diag.numpy(), np.diag(np.sqrt(np.diag(chol_j @ chol_j.T))),
                               rtol=1e-5, atol=1e-6)
    bad = torch.tensor(wsq)
    bad[0, 0] = -1e6
    _, kept = tn._refresh(da_t, old, torch.tensor(wsum), bad, wn, True)
    assert torch.equal(kept, old)


def test_one_leapfrog_matches_reference():
    X, Y, mask, k = _saas_problem()
    d = X.shape[1]
    C = 3
    rng = np.random.default_rng(3)
    Z = _saas_starts(C, k, d, 3).astype(np.float32)
    R = rng.normal(size=(C, k)).astype(np.float32)
    eps = np.array([0.05, -0.1, 0.2], np.float32)
    chol = np.linalg.cholesky(np.eye(k) + 0.3 * np.ones((k, k))).astype(np.float32)
    pj, _, _ = j_make_saas_potential(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                                     mask=jnp.asarray(mask))
    pg_j = _j_safe(jax.value_and_grad(pj))
    L = jnp.asarray(chol)

    def j_leapfrog(z, r, e):
        _, g = pg_j(z)
        r_half = r - 0.5 * e * g
        z_new = z + e * jn._velocity(r_half, L)
        pe_new, g_new = pg_j(z_new)
        return z_new, r_half - 0.5 * e * g_new, pe_new, g_new

    ref = jax.jit(jax.vmap(j_leapfrog))(jnp.asarray(Z), jnp.asarray(R), jnp.asarray(eps))
    pt, _, _ = t_make_saas_potential(torch.tensor(X, dtype=torch.float32),
                                     torch.tensor(Y, dtype=torch.float32), mask=torch.tensor(mask))
    pg_t = value_and_grad_safe(pt)
    z = torch.tensor(Z)
    _, g = pg_t(z)
    inv_mass = torch.tensor(chol) @ torch.tensor(chol).T
    got = tn.leapfrog(pg_t, z, torch.tensor(R), g, torch.tensor(eps)[:, None], inv_mass)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5 * np.abs(b).max())


def test_one_tree_float64_matches_reference_exactly():
    max_depth, C, k = 3, 8, K_QUARTIC
    with jax.enable_x64(True):
        pg_j = _j_safe(jax.value_and_grad(j_quartic))
        step_fn = _j_transition(pg_j, jnp.asarray(CHOL_Q), max_depth)
        pg_jv = jax.jit(jax.vmap(pg_j))
        pg_t = value_and_grad_safe(t_quartic)
        for seed, step in ((0, 0.25), (1, 0.25), (2, 0.8)):
            Z = 2.0 * np.random.default_rng(seed).normal(size=(C, k))
            keys = jax.random.split(jax.random.PRNGKey(seed), C)
            pe, g = pg_jv(jnp.asarray(Z))
            zj, pej, gj, stj = step_fn(jnp.asarray(Z), pe, g, keys, jnp.asarray(step, jnp.float64))
            draws = rebuild_draws(keys, k, max_depth, torch.float64)
            zt = torch.tensor(Z)
            pet, gt = pg_t(zt)
            z2, pe2, g2, st = tn.nuts_transition(
                pg_t, zt, pet, gt, torch.tensor(step, dtype=torch.float64),
                torch.tensor(CHOL_Q), max_depth, draws=draws,
            )
            _assert_same_tree(stj, st, max_depth)
            np.testing.assert_allclose(st["accept_prob"].numpy(), np.asarray(stj["accept_prob"]),
                                       rtol=1e-12, atol=1e-300)
            for a, b in ((z2, zj), (pe2, pej), (g2, gj)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
        # the larger step diverges on some chains and not others
        assert 0 < int(st["diverging"].sum()) < C


def test_one_tree_float32_saas_potential_matches_reference():
    max_depth, C = 2, 4
    X, Y, mask, k = _saas_problem()
    d = X.shape[1]
    Z = _saas_starts(C, k, d, 4).astype(np.float32)
    pj, _, _ = j_make_saas_potential(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                                     mask=jnp.asarray(mask))
    pg_j = _j_safe(jax.value_and_grad(pj))
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    pe, g = jax.jit(jax.vmap(pg_j))(jnp.asarray(Z))
    step = jnp.asarray(0.3, jnp.float32)
    zj, pej, _, stj = _j_transition(pg_j, jnp.eye(k), max_depth)(jnp.asarray(Z), pe, g, keys, step)
    # the fit's potential: value and gradient in closed form
    pg_t = tn.safe(t_make_saas_potential_and_grad(
        torch.tensor(X, dtype=torch.float32), torch.tensor(Y, dtype=torch.float32),
        mask=torch.tensor(mask)))
    zt = torch.tensor(Z)
    pet, gt = pg_t(zt)
    z2, pe2, _, st = tn.nuts_transition(pg_t, zt, pet, gt, torch.tensor(0.3), torch.eye(k),
                                        max_depth, draws=rebuild_draws(keys, k, max_depth, torch.float32))
    _assert_same_tree(stj, st, max_depth)
    np.testing.assert_allclose(z2.numpy(), np.asarray(zj), atol=1e-4)
    np.testing.assert_allclose(pe2.numpy(), np.asarray(pej), rtol=1e-5)
    assert (st["depth"] > 1).any()


def test_lockstep_chains_equal_chains_alone():
    """A chain that stops early holds its state and its place in the
    uniform stream: every chain's result equals its run alone, and
    changing the uniforms it did not read changes nothing."""
    max_depth, C, k = 4, 5, K_QUARTIC
    gen = torch.Generator().manual_seed(0)
    Z = 2.0 * torch.randn(C, k, generator=gen, dtype=torch.float64)
    draws = tn.draw_transition(gen, C, k, max_depth, torch.float64, "cpu")
    pg = value_and_grad_safe(t_quartic)
    pe, g = pg(Z)
    chol = torch.tensor(CHOL_Q)
    step = torch.tensor(0.3, dtype=torch.float64)
    tn.nuts_transition.host_reads = tn.nuts_transition.leapfrogs = 0
    z, pe2, g2, st = tn.nuts_transition(pg, Z, pe, g, step, chol, max_depth, draws=draws)
    depth = st["depth"]
    assert len(set(depth.tolist())) > 1, "the chains should stop at different depths"
    assert tn.nuts_transition.host_reads <= max_depth - 1
    assert tn.nuts_transition.leapfrogs == 2 ** int(depth.max()) - 1
    used = st["uniforms_used"]
    assert torch.equal(used, st["num_leaves"].long() + depth)
    for c in range(C):
        one = tn.TransitionDraws(*(t[c:c + 1] for t in draws))
        z1, pe1, g1, st1 = tn.nuts_transition(pg, Z[c:c + 1], pe[c:c + 1], g[c:c + 1], step, chol,
                                              max_depth, draws=one)
        torch.testing.assert_close(z1[0], z[c], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(pe1[0], pe2[c], rtol=1e-12, atol=1e-12)
        for key in ("depth", "num_leaves", "diverging", "turning", "uniforms_used"):
            assert st1[key][0] == st[key][c], key
    # uniforms past each chain's stream position are never read
    u = draws.uniforms.clone()
    past = torch.arange(u.shape[1])[None, :] >= used[:, None]
    u[past] = 0.5 * u[past]
    z3, _, _, st3 = tn.nuts_transition(pg, Z, pe, g, step, chol, max_depth,
                                       draws=draws._replace(uniforms=u))
    assert torch.equal(z3, z) and torch.equal(st3["depth"], depth)
    with pytest.raises(ValueError, match="Generator"):
        tn.nuts_transition(pg, Z, pe, g, step, chol, max_depth)


@pytest.mark.slow
def test_one_tree_depth6_float64_matches_reference():
    max_depth, C, k = 6, 8, K_QUARTIC
    with jax.enable_x64(True):
        pg_j = _j_safe(jax.value_and_grad(j_quartic))
        Z = 3.0 * np.random.default_rng(5).normal(size=(C, k))
        keys = jax.random.split(jax.random.PRNGKey(5), C)
        pe, g = jax.jit(jax.vmap(pg_j))(jnp.asarray(Z))
        zj, _, _, stj = _j_transition(pg_j, jnp.asarray(CHOL_Q), max_depth)(
            jnp.asarray(Z), pe, g, keys, jnp.asarray(0.1, jnp.float64))
        pg_t = value_and_grad_safe(t_quartic)
        zt = torch.tensor(Z)
        pet, gt = pg_t(zt)
        z2, _, _, st = tn.nuts_transition(pg_t, zt, pet, gt, torch.tensor(0.1, dtype=torch.float64),
                                          torch.tensor(CHOL_Q), max_depth,
                                          draws=rebuild_draws(keys, k, max_depth, torch.float64))
        _assert_same_tree(stj, st, max_depth)
        assert int(st["depth"].max()) >= 4
        np.testing.assert_allclose(z2.numpy(), np.asarray(zj), rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_run_nuts_matches_reference_with_injected_draws():
    """Warmup (dual averaging, two mass refreshes) and sampling, every
    transition's draws rebuilt from the JAX run's keys."""
    C, k, warmup, samples, max_depth = 4, K_QUARTIC, 48, 8, 4
    with jax.enable_x64(True):
        Z = np.random.default_rng(6).normal(size=(C, k))
        key = jax.random.PRNGKey(6)
        sj, stats_j = jax.jit(lambda z0, key: jn.run_nuts(
            j_quartic, z0, key, num_warmup=warmup, num_samples=samples, max_depth=max_depth))(
            jnp.asarray(Z), key)
        chain_keys = []
        for _ in range(warmup + samples):
            key, sub = jax.random.split(key)
            chain_keys.append(jax.random.split(sub, C))
        all_draws = [rebuild_draws(kk, k, max_depth, torch.float64) for kk in chain_keys]
    st, stats_t = tn.run_nuts(value_and_grad_safe(t_quartic), torch.tensor(Z),
                              num_warmup=warmup, num_samples=samples,
                              max_depth=max_depth, draws=lambda i: all_draws[i])
    assert tn._warmup_schedule(warmup) == [32, 44]
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-9, atol=1e-9)
    for key_ in ("accept_prob", "divergence_rate", "step_size"):
        np.testing.assert_allclose(float(stats_t[key_]), float(stats_j[key_]), rtol=1e-9)


def test_overflowing_momentum_is_a_divergence_with_accept_zero():
    """A leaf whose momentum overflows float32 diverges with accept
    probability 0, as the reference's `0.5 |L^T r|^2` gives (+inf kinetic
    energy). Summing `r * (M^-1 r)` instead meets +inf and -inf terms under
    a mass matrix with negative correlations and gives NaN, which the mean
    over chains passes to the adapted step size."""
    chol = torch.linalg.cholesky(torch.tensor([[1.0, -0.5], [-0.5, 0.3]]))
    grad = 1e22

    def pg(z):
        return grad * z.sum(-1), torch.full_like(z, grad)

    z = torch.zeros(3, 2)
    pe, g = pg(z)
    _, _, _, st = tn.nuts_transition(tn.safe(pg), z, pe, g, torch.tensor(0.1), chol, 3,
                                     torch.Generator().manual_seed(0))
    assert bool(st["diverging"].all())
    assert torch.equal(st["accept_prob"], torch.zeros(3))
