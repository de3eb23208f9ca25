"""Port parity for kernel K1's module (`ops/mvn_linalg.py`) and the
Cholesky helpers (`ops/chol.py`) against botorch_tpu on the CPU.

K1's plain version `qd_plain` is held to the JAX package's own CPU path
`_qd_jnp`, and the differentiable `mvn_quad_logdet` to JAX's
`mvn_quad_logdet` (values and closed-form gradients) at the shapes of
`tests/test_pallas_linalg.py` and the BO loop's fit (B = 2, n = 35).
Matrices are `A A^T + n I` (condition number < 10), so float32 results
agree to rtol 1e-5 (a Cholesky of n <= 64 in two summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.ops import chol as jc
from botorch_tpu.ops.pallas_linalg import _qd_jnp, mvn_quad_logdet as j_mvn
from botorch_tpu_torch.ops import chol as tc
from botorch_tpu_torch.ops import mvn_linalg as tm
from _torch_threads import _one_torch_thread  # noqa: F401


SHAPES = [(7, 13), (32, 24), (8, 64), (2, 35)]


def _spd(B, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    K = (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)
    r = rng.normal(size=(B, n)).astype(dtype)
    return K, r


def _close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,n", SHAPES)
def test_qd_plain_matches_qd_jnp(B, n):
    K, r = _spd(B, n)
    quad, ld, alpha, kinv = tm.qd_plain(torch.tensor(K), torch.tensor(r))
    jq, jld, jalpha, jkinv = jax.jit(_qd_jnp)(jnp.asarray(K), jnp.asarray(r))
    _close(quad, jq)
    _close(ld, jld)
    _close(alpha, jalpha, atol=1e-6)
    _close(kinv, jkinv, atol=1e-7)


@pytest.mark.parametrize("B,n", SHAPES)
def test_mvn_quad_logdet_values_and_grads(B, n):
    K, r = _spd(B, n, seed=1)
    Kt = torch.tensor(K, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    q, ld = tm.mvn_quad_logdet(Kt, rt)
    dK, dr = torch.autograd.grad((q + 0.3 * ld).sum(), (Kt, rt))

    def f(K, r):
        q, ld = j_mvn(K, r)
        return (q + 0.3 * ld).sum(), (q, ld)

    (_, (jq, jld)), (jdK, jdr) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(K), jnp.asarray(r))
    _close(q, jq)
    _close(ld, jld)
    _close(dK, jdK, atol=1e-6)
    _close(dr, jdr, atol=1e-6)


def test_leading_batch_dims_and_broadcast_r():
    K, r = _spd(6, 9, seed=2)
    K2 = torch.tensor(K).reshape(2, 3, 9, 9)
    q, ld = tm.mvn_quad_logdet(K2, torch.tensor(r[0]))  # r broadcast over batch
    jq, jld = j_mvn(jnp.asarray(K).reshape(2, 3, 9, 9), jnp.asarray(r[0]))
    assert q.shape == (2, 3) and ld.shape == (2, 3)
    _close(q, jq)
    _close(ld, jld)


def test_large_n_path_matches_jax():
    K, r = _spd(2, 80, seed=3)
    Kt = torch.tensor(K, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    q, ld = tm.mvn_quad_logdet(Kt, rt)
    dK, dr = torch.autograd.grad((q - ld).sum(), (Kt, rt))
    f = lambda K, r: jnp.sum(j_mvn(K, r)[0] - j_mvn(K, r)[1])  # noqa: E731
    jdK, jdr = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(K), jnp.asarray(r))
    jq, jld = j_mvn(jnp.asarray(K), jnp.asarray(r))
    _close(q, jq)
    _close(ld, jld)
    _close(dK, jdK, atol=1e-6)
    _close(dr, jdr, atol=1e-6)


def test_float64_plain_path():
    K, r = _spd(3, 20, seed=4, dtype=np.float64)
    q, ld = tm.mvn_quad_logdet(torch.tensor(K), torch.tensor(r))
    a = np.linalg.solve(K, r[..., None])[..., 0]
    np.testing.assert_allclose(q.numpy(), np.einsum("bi,bi->b", r, a), rtol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(K)[1], rtol=1e-12)


def test_non_pd_gives_nan_like_the_kernel():
    K = np.stack([np.eye(4), -np.eye(4)]).astype(np.float32)
    q, ld = tm.mvn_quad_logdet(torch.tensor(K), torch.ones(2, 4))
    assert torch.isfinite(q[0]) and torch.isnan(q[1]) and torch.isnan(ld[1])
    jq, _ = j_mvn(jnp.asarray(K), jnp.ones((2, 4)))
    assert np.isnan(np.asarray(jq)[1])


# ---------------------------------------------------------------- chol ----
def test_add_jitter_and_logdet():
    K, _ = _spd(3, 6, seed=5)
    _close(tc.add_jitter(torch.tensor(K), 1e-3), jc.add_jitter(jnp.asarray(K), 1e-3))
    L = tc.cholesky(torch.tensor(K))
    _close(L, jc.cholesky(jnp.asarray(K)), atol=1e-5)
    _close(tc.chol_logdet(L), jc.chol_logdet(jnp.asarray(L.numpy())))


@pytest.mark.parametrize("trans", [False, True])
def test_solves(trans):
    K, r = _spd(2, 7, seed=6)
    L = np.linalg.cholesky(K.astype(np.float64)).astype(np.float32)
    b = r[..., None]
    _close(tc.solve_triangular(torch.tensor(L), torch.tensor(b), trans=trans),
           jc.solve_triangular(jnp.asarray(L), jnp.asarray(b), trans=trans), atol=1e-6)
    _close(tc.cholesky_solve(torch.tensor(L), torch.tensor(b)),
           jc.cholesky_solve(jnp.asarray(L), jnp.asarray(b)), atol=1e-6)


@pytest.mark.parametrize("n", [12, 300])
def test_psd_safe_cholesky_escalates_like_jax(n):
    """Both probes (all rungs at n <= 256, one at a time above) pick the
    same jitter rung as the reference on a rank-deficient matrix."""
    rng = np.random.default_rng(7)
    V = rng.normal(size=(n, 3))
    A = (V @ V.T).astype(np.float32)  # rank 3: the base jitter rung fails
    Lt = tc.psd_safe_cholesky(torch.tensor(A))
    Lj = jc.psd_safe_cholesky(jnp.asarray(A))
    assert torch.isfinite(Lt).all()
    np.testing.assert_allclose(
        np.diag(Lt.numpy()) ** 2, np.diag(np.asarray(Lj)) ** 2, rtol=0.05, atol=1e-3
    )
    # the chosen jitter level is visible in the smallest pivot
    np.testing.assert_allclose(
        np.min(np.diag(Lt.numpy())), np.min(np.diag(np.asarray(Lj))), rtol=0.05
    )


def test_psd_safe_cholesky_gradient_flows():
    K, _ = _spd(1, 5, seed=8)
    Kt = torch.tensor(K[0], requires_grad=True)
    (g,) = torch.autograd.grad(tc.chol_logdet(tc.psd_safe_cholesky(Kt)), Kt)
    jg = jax.grad(lambda A: jc.chol_logdet(jc.psd_safe_cholesky(A)))(jnp.asarray(K[0]))
    _close(g, jg, atol=1e-6)


def _rungs(A, L):
    """The ladder rung each factor was taken at, read off its diagonal:
    `diag(L L^T) - diag(A) = jitter * max(mean |diag A|, floor)`."""
    A = np.asarray(A, np.float64)
    L = np.asarray(L, np.float64)
    added = np.einsum("...ij,...ij->...i", L, L) - np.einsum("...ii->...i", A)
    scale = np.maximum(np.abs(np.einsum("...ii->...i", A)).mean(-1), 1e-10)
    jitter = (added.mean(-1) / scale).reshape(A.shape[0], -1).max(-1)
    ladder = np.asarray(tc._JITTER_LADDER) + tc.DEFAULT_JITTER
    return np.abs(np.log(jitter[:, None]) - np.log(ladder[None, :])).argmin(-1)


def _with_lowest_eigenvalue(n, lowest, seed):
    """A float32 covariance of mean diagonal ~1 whose smallest eigenvalue is
    `lowest`: positive is well conditioned; negative is what the float32
    cancellation of a singular posterior covariance leaves."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.linspace(0.5, 1.5, n)
    lam[0] = lowest
    return ((Q * lam) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("n", [12, 300])
@pytest.mark.parametrize("matrices_per_element,expected", [(1, [0, 3, 0]), (2, [0, 3, 5])])
def test_psd_safe_cholesky_picks_the_rung_per_batch_element(n, matrices_per_element, expected):
    """A t-batch of a well-conditioned covariance and two that need the
    1e-2 and 1.0 rungs: each element takes its own rung, as the JAX function
    mapped over the batch with `vmap` does (at n <= 256 every rung is
    probed at once, above one at a time). Within an element every matrix
    must factor (here two outputs, the posterior's `(b, m, q, q)` layout)."""
    lows = [(0.3, 0.4), (-5e-3, 0.2), (0.2, -0.5)]
    A = np.stack([
        np.stack([_with_lowest_eigenvalue(n, lo, 10 * i + j)
                  for j, lo in enumerate(pair[:matrices_per_element])])
        for i, pair in enumerate(lows)
    ])  # (3, matrices_per_element, n, n)
    Lt = tc.psd_safe_cholesky(torch.tensor(A), batch_dims=1)
    Lj = jax.jit(jax.vmap(jc.psd_safe_cholesky))(jnp.asarray(A))
    assert torch.isfinite(Lt).all()
    rungs_j = _rungs(A, Lj)
    np.testing.assert_array_equal(rungs_j, expected)
    np.testing.assert_array_equal(_rungs(A, Lt.numpy()), rungs_j)
    # batch_dims=0 keeps the unmapped function: one rung for the whole tensor
    L0 = tc.psd_safe_cholesky(torch.tensor(A))
    np.testing.assert_array_equal(_rungs(A, L0.numpy()), _rungs(A, jc.psd_safe_cholesky(jnp.asarray(A))))
    with pytest.raises(ValueError):
        tc.psd_safe_cholesky(torch.tensor(A), batch_dims=3)
