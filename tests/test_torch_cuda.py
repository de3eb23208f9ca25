"""On-card tests of the port's CUDA kernels against their plain versions.

They need a CUDA device and `nvcc`, and skip without them. Run them on the
card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances are `chip_smoke.py`'s, with the same reasons.
"""

import numpy as np
import pytest
import torch
from _torch_threads import _one_torch_thread  # noqa: F401


pytestmark = pytest.mark.cuda

KINDS = ["rbf", "matern52", "matern32", "matern12"]
K1_SHAPES = [(7, 13), (32, 24), (8, 64), (2, 35), (3, 1)] + [
    (B, n) for B in (1, 5, 33) for n in (1, 31, 32, 33)] + [(200, 35), (200, 64), (8, 26), (64, 24),
                                                            (2, 30), (2, 22)]
K2_SHAPES = [(2, 35, 35, 2, True), (1, 35, 35, 2, True), (1, 300, 257, 7, False),
             (6, 35, 1, 2, False), (6, 1, 1, 2, False), (64, 35, 1, 2, False),
             (64, 1, 1, 2, False), (80, 35, 1, 2, False), (80, 1, 1, 2, False),
             (1, 64, 48, 8, False), (3, 20, 33, 20, False),
             # the config-2 qLogNEI loop's launches, all on the tiled path
             (2, 76, 76, 6, True), (1, 76, 76, 6, True), (64, 76, 80, 6, False),
             (64, 80, 80, 6, False), (6, 76, 80, 6, False), (6, 80, 80, 6, False),
             # the config-4 qLogNEHVI loop's: the fit's and train_chol's 90
             # padded rows, the joint posterior of 90 baseline rows and 1-4 picks
             (2, 90, 90, 2, True), (1, 90, 90, 2, True), (32, 90, 91, 2, False),
             (4, 90, 94, 2, False), (4, 94, 94, 2, False)]


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


def _k1_tol(dtype):
    return (1e-5, 2e-5) if dtype == torch.float32 else (1e-12, 1e-11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", K1_SHAPES)
def test_k1_kernel_matches_plain(dev, B, n, dtype):
    """quad, logdet, alpha and Kinv against the plain version; Kinv exactly
    symmetric, as the kernel forms it."""
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda, qd_plain

    K, r = (t.to(dev) for t in _spd(B, n, dtype))
    got = qd_cuda(K, r)
    ref = qd_plain(K, r)
    torch.cuda.synchronize()
    atol, rtol = _k1_tol(dtype)
    assert len(got) == 4
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=atol + rtol * float(b.abs().max()), rtol=0)
    assert torch.equal(got[3], got[3].transpose(-1, -2))


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
def test_k1_non_pd_matrix_gives_nan_beside_good_ones(dev, dtype):
    """A matrix that does not factor gives NaN; its neighbours in the batch
    (other thread groups, other blocks) stay right."""
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda, qd_plain

    K, r = (t.to(dev) for t in _spd(3, 35, dtype, seed=2))
    K[1, 5, 5] = -1.0
    got = qd_cuda(K, r)
    torch.cuda.synchronize()
    assert torch.isnan(got[0][1]) and torch.isnan(got[1][1])
    ref = qd_plain(K[[0, 2]], r[[0, 2]])
    atol, rtol = _k1_tol(dtype)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a[[0, 2]], b, atol=atol + rtol * float(b.abs().max()), rtol=0)


def test_k1_op_launches_no_gemm_for_kinv(dev):
    """The differentiable op's forward is K1 alone (it writes Kinv)."""
    from torch.profiler import ProfilerActivity, profile

    from botorch_tpu_torch.ops.mvn_linalg import mvn_quad_logdet

    K, r = (t.to(dev) for t in _spd(2, 35, torch.float32, seed=3))
    mvn_quad_logdet(K, r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mvn_quad_logdet(K, r)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("mvn_qd_kernel" in k for k in names), names


def _k2_grad_tol(dtype, kind, coincident):
    if dtype == torch.float32:
        return (1e-6, 2e-3) if (kind == "matern12" and coincident) else (1e-6, 1e-5)
    return (1e-14, 1e-7) if (kind == "matern12" and coincident) else (1e-14, 1e-11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("B,n,m,d,coincident", K2_SHAPES)
def test_k2_kernel_matches_plain(dev, kind, B, n, m, d, coincident, dtype):
    _check_k2(dev, kind, B, n, m, d, coincident, dtype)


# config 5's (TuRBO): the SVGP's (d = 20, one unbatched problem each) Kzz,
# Kzx and Kxx of a 512-point minibatch, its paths' Kxz at 2048 candidates
# and the greedy pivots' column over the loop's history sizes, matern52;
# the exact GP's paths at 4096 candidates and its 2048-point train
# covariance, rbf; the exact Ackley-4 loop's (rbf, d = 4) fit covariance
# for 2 restarts, `train_chol`'s, and its paths' k(Xc, X) at 256 candidates
K2_CONFIG5 = [(1, 256, 256, 20, True, "matern52"), (1, 256, 512, 20, False, "matern52"),
              (1, 512, 512, 20, True, "matern52"), (1, 2048, 256, 20, False, "matern52"),
              (1, 16384, 1, 20, False, "matern52"), (1, 16448, 1, 20, False, "matern52"),
              (1, 16512, 1, 20, False, "matern52"), (1, 16576, 1, 20, False, "matern52"),
              (1, 4096, 2048, 20, False, "rbf"), (1, 2048, 2048, 20, True, "rbf"),
              (2, 40, 40, 4, True, "rbf"), (1, 40, 40, 4, True, "rbf"),
              (1, 256, 40, 4, False, "rbf")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m,d,coincident,kind", K2_CONFIG5)
def test_k2_at_config5_shapes_matches_plain(dev, kind, B, n, m, d, coincident, dtype):
    _check_k2(dev, kind, B, n, m, d, coincident, dtype)


# the constrained loops' (rbf): ConstrainedGramacy's fit and train covariances
# of 30 padded rows (d = 2) and its LogCEI's k(x_train, X), k(X, X) at the 6
# restarts and 64 raw points; the same for Hartmann-6 under sum(x) <= 3 (22
# rows, d = 6)
K2_CONSTRAINED = [(B, n, m, d, c, "rbf") for n, d in ((30, 2), (22, 6))
                  for B, m, c in ((2, n, True), (1, n, True), (6, 1, False), (64, 1, False))]
K2_CONSTRAINED += [(B, 1, 1, d, False, "rbf") for d in (2, 6) for B in (6, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,m,d,coincident,kind", K2_CONSTRAINED)
def test_k2_at_constrained_loop_shapes_matches_plain(dev, kind, B, n, m, d, coincident, dtype):
    _check_k2(dev, kind, B, n, m, d, coincident, dtype)


@pytest.mark.parametrize("name", ["outcome_qlogei", "simplex_logei", "interpoint_budget",
                                  "nonlinear_ball"])
def test_constrained_branch_on_the_card_matches_the_cpu(dev, name):
    """One constrained `optimize_acqf` of each branch on the card and on the
    CPU from the same fit starts and initial conditions
    (`chip_smoke.constrained_step_case`): the card's candidates violate
    their constraints by at most 1e-5, and lie within 2e-2 of the CPU's or
    score as high under the CPU's acquisition."""
    import chip_smoke

    case = chip_smoke.constrained_step_case(name)
    assert case["violation"]["cuda"] <= 1e-5, case
    assert case["ok"], case


def test_constrained_loops_run_on_the_card_through_both_kernels(dev):
    """Two iterations of each constrained loop on the card: K1 carries the
    fits' MLL, K2 every kernel matrix, and every Hartmann point satisfies
    sum(x) <= 3."""
    import chip_smoke

    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda

    tiny = dict(chip_smoke.LOOP_CFG, num_restarts=3, raw_samples=16, fit_maxiter=5, acq_maxiter=5)
    for loop in (chip_smoke.gramacy_loop, chip_smoke.hartmann_linear_loop):
        qd_cuda.launches = kernel_matrix_cuda.launches = 0
        X, Y = loop(seed=0, n_init=6, iterations=2, cfg=tiny)
        assert X.is_cuda and bool(torch.isfinite(Y).all())
        assert bool(((X >= 0) & (X <= 1)).all())
        assert qd_cuda.launches > 0 and kernel_matrix_cuda.launches > 0
    assert float(X.sum(-1).max()) <= 3.0 + 1e-5


def _check_k2(dev, kind, B, n, m, d, coincident, dtype):
    """Values against the plain version in float64 (reasons at
    `chip_smoke.K2_ATOL`); the op's gradients (x, z, lengthscale) against
    autograd of the plain version, each within atol + rtol * max |ref|
    (reasons at `chip_smoke.K2_GRAD_TOL`)."""
    from botorch_tpu_torch.ops.kernel_matrix import (
        kernel_matrix, kernel_matrix_cuda, kernel_matrix_plain)

    g = torch.Generator().manual_seed(0)
    x = torch.rand(n, d, generator=g, dtype=torch.float64).to(dtype).to(dev)
    z = x if coincident else torch.rand(B, m, d, generator=g, dtype=torch.float64).to(dtype).to(dev)
    ls = (0.1 + torch.rand(B, d, generator=g, dtype=torch.float64)).to(dtype).to(dev)
    out = kernel_matrix_cuda(x, z, ls, kind)
    # the plain version in float64 on the same inputs (reasons at `chip_smoke.K2_ATOL`)
    ref = kernel_matrix_plain(x.double(), z.double(), ls.double(), kind)
    torch.cuda.synchronize()
    small = 1e-5 if dtype == torch.float32 else 1e-12
    atol = {"matern12": 2e-3 if dtype == torch.float32 else 1e-7}.get(kind, small)
    if kind == "matern12" and dtype == torch.float64 and coincident and d > 2:
        atol = 1e-6  # the float64 expansion's cancellation at d = 6 (`chip_smoke.K2_ATOL`)
    assert out.dtype == dtype
    torch.testing.assert_close(out.double(), ref, atol=atol, rtol=0)
    w = torch.randn(ref.shape, generator=g, dtype=torch.float64).to(dtype).to(dev)
    inputs = [t.clone().requires_grad_(True) for t in (x, z, ls)]
    grads = torch.autograd.grad(kernel_matrix(*inputs, kind), inputs, w)
    inputs_p = [t.clone().requires_grad_(True) for t in (x, z, ls)]
    grads_p = torch.autograd.grad(kernel_matrix_plain(*inputs_p, kind), inputs_p, w)
    gatol, grtol = _k2_grad_tol(dtype, kind, coincident)
    for a, b in zip(grads, grads_p):
        torch.testing.assert_close(a, b, atol=gatol + grtol * float(b.abs().max()), rtol=0)


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


def test_qlognei_loop_runs_on_the_card_through_k2(dev):
    """Two qLogNEI iterations at config 2's widths (d = 6, q = 4, capacity
    24 + 4 candidates) on the card: K2 carries every kernel matrix."""
    from botorch_tpu_torch.loop import run_bo_loop
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.test_functions.synthetic import Hartmann

    kernel_matrix_cuda.launches = 0
    st = run_bo_loop(Hartmann(dim=6, negate=True), d=6, n_init=16, iterations=2, q=4,
                     acqf_name="qLogNEI", mc_samples=32, num_restarts=3, raw_samples=16,
                     fit_restarts=2, fit_maxiter=5, acq_maxiter=5)
    X = st.X[: st.n]
    assert st.n == 24 and X.is_cuda and torch.isfinite(st.Y).all()
    assert bool(((X >= 0) & (X <= 1)).all())
    assert kernel_matrix_cuda.launches > 0


@pytest.mark.parametrize("B,n", [(8, 26), (64, 24)])
def test_k1_nan_member_at_the_nuts_shapes(dev, B, n):
    """Config 3's NUTS potential (8 chains, 26 rows) and the NUTS
    throughput shape (64, 24): a chain whose covariance does not factor,
    as in a divergent leapfrog, gives NaN and leaves the others right."""
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda, qd_plain

    K, r = (t.to(dev) for t in _spd(B, n, torch.float32, seed=3))
    K[B // 2, 3, 3] = -1.0
    got = qd_cuda(K, r)
    torch.cuda.synchronize()
    assert torch.isnan(got[0][B // 2]) and torch.isnan(got[1][B // 2])
    keep = [i for i in range(B) if i != B // 2]
    ref = qd_plain(K[keep], r[keep])
    atol, rtol = _k1_tol(torch.float32)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a[keep], b, atol=atol + rtol * float(b.abs().max()), rtol=0)


def test_nuts_transition_on_the_card_matches_the_cpu(dev):
    """One transition of 8 chains on the SAAS potential of a 26-row padded
    history (10 valid, d = 8), the same chain starts and draws on both
    sides: the same trees; z within 1e-3, the potential within 1e-4
    relative (`chip_smoke.py`'s `nuts_step` tolerances)."""
    from botorch_tpu_torch.models.fully_bayesian import (
        init_saas_chains,
        make_saas_potential_and_grad,
    )
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.sampling import nuts
    from botorch_tpu_torch.settings import make_generator

    rng = np.random.default_rng(0)
    X = np.zeros((26, 8), np.float32)
    X[:10] = rng.uniform(size=(10, 8))
    Y = np.zeros(26, np.float32)
    Y[:10] = np.sin(6 * X[:10, 0]) + X[:10, 1]
    mask = np.arange(26) < 10
    gen = make_generator(0, "cpu")
    z0 = init_saas_chains(gen, 8, 8, True)
    draws = nuts.draw_transition(gen, 8, z0.shape[1], 6, torch.float32, "cpu")
    out = {}
    for d in ("cpu", dev):
        base = make_gp(X, Y, kernel="matern52", use_outputscale=True, mask=mask, device=d)
        pg = nuts.safe(make_saas_potential_and_grad(base.X, base.Y[:, 0], mask=base.mask))
        k = z0.shape[1]
        pe, g = pg(z0.to(d))
        z1, pe1, _, st = nuts.nuts_transition(
            pg, z0.to(d), pe, g, torch.tensor(0.1, device=d), torch.eye(k, device=d), 6,
            draws=nuts.TransitionDraws(*(t.to(d) for t in draws)))
        out[str(d)] = (z1.cpu(), pe1.cpu(), st["depth"].cpu(), st["num_leaves"].cpu())
    (zc, pc, dc, lc), (zg, pg_, dg, lg) = out["cpu"], out[str(dev)]
    assert torch.equal(dc, dg) and torch.equal(lc, lg)
    torch.testing.assert_close(zg, zc, atol=1e-3, rtol=0)
    torch.testing.assert_close(pg_, pc, rtol=1e-4, atol=0)


def test_saasbo_runs_on_the_card_through_both_kernels(dev):
    """Two SAASBO iterations at config 3's widths (d = 8, 8 chains,
    capacity 12) and a small NUTS budget: K1 carries the potential at
    (8 chains, 12 rows) and K2 every kernel matrix."""
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.saasbo import run_saasbo
    from botorch_tpu_torch.test_functions.synthetic import Branin
    from botorch_tpu_torch.utils.transforms import unnormalize

    prob = Branin(negate=True)
    qd_cuda.launches = kernel_matrix_cuda.launches = 0
    res = run_saasbo(lambda X: prob(unnormalize(X[:, :2], prob.bounds)), d=8, n_init=10,
                     iterations=2, num_warmup=16, num_samples=16, thinning=2, num_chains=8,
                     num_restarts=4, raw_samples=32, acq_maxiter=5)
    assert res.X.is_cuda and res.X.shape == (12, 8) and torch.isfinite(res.Y).all()
    assert qd_cuda.launches > 0 and kernel_matrix_cuda.launches > 0


def test_saasbo_step_on_the_card_matches_the_cpu(dev):
    """One config-3 acquisition step (d = 8, 20 valid rows of 26, a
    16-member ensemble, 32 restarts from the same initial conditions, 512
    raw samples, 50 ascent iterations) on the card and on the CPU from the
    same draws: the values within 1e-3 relative, the CPU's acquisition at
    the card's candidate within 1e-3 of the CPU's optimum, and the two
    active coordinates within 2e-2 (the six distractor coordinates lie on
    a near-flat ridge and are not compared)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from saas_posterior import history

    from botorch_tpu_torch.acquisition.analytic import make_acqf
    from botorch_tpu_torch.saasbo import saasbo_step
    from botorch_tpu_torch.settings import make_generator

    X, Y, mask, _ = history()
    n, d = int(mask.sum()), X.shape[1]
    rng = np.random.default_rng(3)
    z = rng.normal(scale=0.3, size=(16, 4 + d))
    z[:, 1:4] += [0.0, np.log(1e-2), np.log(0.1)]  # outputscale 1, noise 1e-2, tausq 0.1
    z[:, 4:6] += np.log(40.0)  # active lengthscales ~0.5, distractors ~3
    z = torch.tensor(z, dtype=torch.float32)
    ics = torch.tensor(rng.uniform(size=(32, 1, d)), dtype=torch.float32)
    out = {}
    for device in ("cpu", dev):
        cand, val, model, _ = saasbo_step(
            torch.tensor(X, device=device), torch.tensor(Y, device=device), n,
            make_generator(0, device), seed=0, num_restarts=32, raw_samples=512, acq_maxiter=50,
            z_samples=z.to(device), initial_conditions=ics.to(device))
        out[str(device)] = (cand.cpu(), float(val), model)
    (cc, vc, model_c), (cg, vg, _) = out["cpu"], out[str(dev)]
    assert abs(vg - vc) <= 1e-3 * max(1.0, abs(vc))
    acqf = make_acqf("LogEI", model_c, best_f=torch.tensor(float(Y[:n].max())))
    assert abs(float(acqf(cg[None])) - vc) <= 1e-3 * max(1.0, abs(vc))
    torch.testing.assert_close(cg[:, :2], cc[:, :2], atol=2e-2, rtol=0)


def test_mo_loop_runs_on_the_card_through_k2(dev):
    """Two qLogNEHVI iterations at config 4's widths (d = 2, m = 2, q = 4
    sequential greedy, capacity 18) on the card: K2 carries every kernel
    matrix, and the front improves on the initial design's."""
    from botorch_tpu_torch.mo_loop import MOBOState, observed_hypervolume, run_mo_bo_loop
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin

    prob = BraninCurrin(negate=True)
    kernel_matrix_cuda.launches = 0
    st = run_mo_bo_loop(prob, d=2, m=2, ref_point=prob.ref_point, n_init=10, iterations=2, q=4,
                        num_restarts=2, raw_samples=16, fit_restarts=2, fit_maxiter=5,
                        acq_maxiter=5, mc_samples=16)
    X = st.X[: st.n]
    assert st.n == 18 and X.is_cuda and torch.isfinite(st.Y).all()
    assert bool(((X >= 0) & (X <= 1)).all()) and kernel_matrix_cuda.launches > 0
    hv0 = observed_hypervolume(MOBOState(X=st.X, Y=st.Y, n=10), prob.ref_point)
    assert observed_hypervolume(st, prob.ref_point) >= hv0


def test_qlognehvi_on_the_card_matches_the_cpu(dev):
    """Config 4's last pick on the card and on the CPU: qLogNEHVI over 90
    padded baseline rows (10 BraninCurrin points), one candidate and 3
    pending points, 32 MC samples, for the 32 raw candidate sets of an
    ascent's start. Values within 1e-3 relative, gradients within 2e-2 of
    their largest entry: a float32 joint posterior of 94 points, factored
    by cuSOLVER and by LAPACK, whose 80 padded rows (all at the origin)
    make its covariance near-singular. On the CPU the float32 values of
    this input lie up to 6.5e-4 relative (gradients 2.2e-4 of the largest
    entry) from their float64 values."""
    from botorch_tpu_torch.acquisition.monte_carlo import draw_fresh_base_samples
    from botorch_tpu_torch.acquisition.multi_objective import (
        _subset_masks,
        make_in_graph_nehvi_cells,
        qLogNoisyExpectedHypervolumeImprovement,
    )
    from botorch_tpu_torch.models.gp import make_gp
    from botorch_tpu_torch.mo_loop import append_mo_observations, init_mo_state
    from botorch_tpu_torch.settings import make_generator
    from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin

    prob = BraninCurrin(negate=True)
    state, X0 = init_mo_state(10, 2, 2, 90, seed=0, device="cpu")
    state = append_mo_observations(state, X0, prob(X0))
    base = draw_fresh_base_samples(94, 2, 32, make_generator(3, "cpu"), seed=23)
    rng = np.random.default_rng(0)
    pending = torch.tensor(rng.uniform(size=(3, 2)), dtype=torch.float32)
    Xq = torch.tensor(rng.uniform(size=(32, 1, 2)), dtype=torch.float32)
    mask = torch.arange(90) < 10
    params = make_gp(state.X, state.Y, mask=mask, device="cpu").params.map(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=torch.Generator().manual_seed(1)))
    out = {}
    for d in ("cpu", dev):
        model = make_gp(state.X, state.Y, mask=mask, device=d, params=params)
        cache = model.train_chol()
        ref = prob.ref_point.to(d)
        lo, up = make_in_graph_nehvi_cells(model, cache, model.X, base[:, :90].to(d), ref,
                                           baseline_mask=mask.to(d))
        masks, signs = _subset_masks(4, device=d)
        acqf = qLogNoisyExpectedHypervolumeImprovement(
            model=model, cache=cache, base_samples=base.to(d), X_baseline=model.X, ref_point=ref,
            masks=masks, signs=signs, baseline_mask=mask.to(d), cell_lower=lo, cell_upper=up,
            X_pending=pending.to(d))
        x = Xq.to(d).requires_grad_(True)
        v = acqf(x)
        (g,) = torch.autograd.grad(v.sum(), x)
        out[str(d)] = (v.detach().cpu(), g.cpu())
    (vc, gc), (vg, gg) = out["cpu"], out[str(dev)]
    assert torch.isfinite(vg).all() and torch.isfinite(gg).all()
    torch.testing.assert_close(vg, vc, rtol=1e-3, atol=0)
    torch.testing.assert_close(gg, gc, rtol=0, atol=2e-2 * float(gc.abs().max()))


def _svgp_cpu(dtype, n=2000, d=20, M=64, seed=0):
    """An SVGP of config 5's width on the CPU, with random variational and
    kernel parameters."""
    from botorch_tpu_torch.models.approximate_gp import make_svgp

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    Y = -np.sum((X - 0.4) ** 2, axis=-1) + 0.01 * rng.normal(size=n)
    m = make_svgp(X, Y, num_inducing=M, device="cpu", dtype=dtype)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    return m.replace(nu_mean=t(0.3 * rng.normal(size=M)),
                     raw_L=t(np.tril(0.05 * rng.normal(size=(M, M))) + 0.2 * np.eye(M)),
                     raw_lengthscale=t(np.log(rng.uniform(0.5, 2.0, size=d))),
                     raw_noise=t(np.log(0.02)))


def test_svgp_elbo_and_gradient_on_the_card_match_the_cpu(dev):
    """float32, a 512-point minibatch at d = 20 and 64 inducing points: the
    loss `fit_svgp` steps on within 1e-4 relative, its gradient in every
    trained field within 1e-3 of the field's largest entry (a float32
    Cholesky of the jittered Kzz, by cuSOLVER and by LAPACK)."""
    from botorch_tpu_torch.models.approximate_gp import SVGP

    model = _svgp_cpu(torch.float32)
    idx = torch.randint(0, 2000, (512,), generator=torch.Generator().manual_seed(1))
    fields = SVGP.PARAMS + ("Z",)
    out = {}
    for device in ("cpu", dev):
        m = model.to(device)
        vals = {f: getattr(m, f).clone().requires_grad_(True) for f in fields}
        loss = -(m.replace(**vals).elbo(idx.to(device)) + m.replace(**vals).log_prior())
        grads = torch.autograd.grad(loss, [vals[f] for f in fields])
        out[str(device)] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for f, a, b in zip(fields, gg, gc):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()), msg=f)


def test_fit_svgp_step_on_the_card_matches_the_cpu(dev):
    """One Adam step from the same minibatch, float64: every trained field
    within 1e-9 (Adam's first step is lr * g / (|g| + 1e-8), so a
    gradient entry near 1e-8 carries its card-vs-CPU rounding into the
    step amplified ~1e6 times)."""
    from botorch_tpu_torch.models.approximate_gp import SVGP, fit_svgp

    model = _svgp_cpu(torch.float64)
    idx = torch.randint(0, 2000, (1, 512), generator=torch.Generator().manual_seed(2))
    fits = {str(device): fit_svgp(model.to(device), steps=1, batch_size=512,
                                  batch_indices=idx.to(device), device=device)
            for device in ("cpu", dev)}
    for f in SVGP.PARAMS + ("Z",):
        a, b = getattr(fits[str(dev)], f).cpu(), getattr(fits["cpu"], f)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9, msg=f)
    assert float((fits["cpu"].nu_mean - model.nu_mean).abs().max()) > 0.04  # it stepped


def test_turbo_runs_on_the_card_through_k2(dev):
    """Two TuRBO iterations of each model type at config 5's width (d =
    20) on the card: K2 carries every kernel matrix, K1 the exact fit's
    MLL at (2, 20)."""
    from botorch_tpu_torch.ops.kernel_matrix import kernel_matrix_cuda
    from botorch_tpu_torch.ops.mvn_linalg import qd_cuda
    from botorch_tpu_torch.optim.turbo import run_turbo

    def objective(X):
        return -torch.sum((X - 0.4) ** 2, dim=-1)

    for model_type, n_init, k1 in (("exact", 16, True), ("svgp", 1024, False)):
        kernel_matrix_cuda.launches = qd_cuda.launches = 0
        X, Y = run_turbo(objective, d=20, n_init=n_init, iterations=2, q=2, n_candidates=256,
                         fit_maxiter=5, model_type=model_type, svgp_inducing=32, svgp_steps=20)
        assert X.is_cuda and X.shape == (n_init + 4, 20) and bool(torch.isfinite(Y).all())
        assert bool(((X >= 0) & (X <= 1)).all()) and kernel_matrix_cuda.launches > 0
        assert (qd_cuda.launches > 0) == k1
