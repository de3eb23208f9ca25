"""On-card tests of the port's CUDA kernels against their plain versions.

They need a CUDA device and `nvcc`, and skip without them. Run them on the
card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances are `chip_smoke.py`'s, with the same reasons.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KINDS = ["rbf", "matern52", "matern32", "matern12"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(B, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    K = A @ A.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64)
    return K.to(dtype), torch.randn(B, n, generator=g, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(7, 13), (32, 24), (8, 64), (2, 35), (3, 1)])
def test_k1_kernel_matches_plain(dev, B, n, dtype):
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda, qd_plain

    K, r = (t.to(dev) for t in _spd(B, n, dtype))
    got = qd_cuda(K, r)
    ref = qd_plain(K, r)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 2e-5) if dtype == torch.float32 else (1e-12, 1e-11)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=atol + rtol * float(b.abs().max()), rtol=0)


def test_k1_gradient_and_nan(dev):
    from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet, qd_cuda, qd_plain

    K, r = (t.to(dev) for t in _spd(2, 35, torch.float32, seed=1))
    Kg, rg = K.clone().requires_grad_(True), r.clone().requires_grad_(True)
    dK, dr = torch.autograd.grad(sum(t.sum() for t in mvn_quad_logdet(Kg, rg)), (Kg, rg))
    Kp, rp = K.clone().requires_grad_(True), r.clone().requires_grad_(True)
    q, ld, _, _ = qd_plain(Kp, rp)
    dKp, drp = torch.autograd.grad(q.sum() + ld.sum(), (Kp, rp))
    torch.testing.assert_close(dK, 0.5 * (dKp + dKp.mT), atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dr, drp, atol=1e-5, rtol=1e-4)
    bad = -torch.eye(4, device=dev)[None]
    quad, logdet, _, _ = qd_cuda(bad, torch.ones(1, 4, device=dev))
    assert torch.isnan(quad).all() and torch.isnan(logdet).all()
    with pytest.raises(ValueError):
        qd_cuda(torch.eye(65, device=dev)[None], torch.ones(1, 65, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,n,m,d,coincident", [(2, 35, 35, 2, True), (1, 300, 257, 7, False),
                                                (6, 35, 1, 2, False), (1, 64, 48, 8, False),
                                                (3, 20, 33, 20, False)])
def test_k2_kernel_matches_plain(dev, kind, B, n, m, d, coincident, dtype):
    from botorch_tpu_torch.ops.kernel_matrix import (
        kernel_matrix, kernel_matrix_cuda, kernel_matrix_plain)

    g = torch.Generator().manual_seed(0)
    x = torch.rand(n, d, generator=g, dtype=torch.float64).to(dtype).to(dev)
    z = x if coincident else torch.rand(B, m, d, generator=g, dtype=torch.float64).to(dtype).to(dev)
    ls = (0.1 + torch.rand(B, d, generator=g, dtype=torch.float64)).to(dtype).to(dev)
    out = kernel_matrix_cuda(x, z, ls, kind)
    ref = kernel_matrix_plain(x, z, ls, kind)
    torch.cuda.synchronize()
    small = 1e-5 if dtype == torch.float32 else 1e-12
    atol = {"matern12": 2e-3 if dtype == torch.float32 else 1e-7}.get(kind, small)
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)
    inputs = [t.clone().requires_grad_(True) for t in (x, z, ls)]
    grads = torch.autograd.grad(kernel_matrix(*inputs, kind).sum(), inputs)
    assert all(torch.isfinite(gr).all() for gr in grads)


def test_entry_points_run_on_the_card_through_both_kernels(dev):
    from botorch_tpu_torch.loop import best_observed, run_bo_loop
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    m = make_gp(np.random.default_rng(0).uniform(size=(5, 2)), np.arange(5.0))
    assert m.X.is_cuda
    prob = Branin(negate=True)
    qd_cuda.launches = kernel_matrix_cuda.launches = 0
    st = run_bo_loop(lambda X: prob(unnormalize(X, prob.bounds)), d=2, n_init=6, iterations=3,
                     num_restarts=3, raw_samples=16, fit_restarts=2, fit_maxiter=5,
                     acq_maxiter=5)
    assert st.X.is_cuda and torch.isfinite(best_observed(st))
    assert qd_cuda.launches > 0 and kernel_matrix_cuda.launches > 0
