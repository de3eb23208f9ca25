"""Port parity for the m = 2 multi-objective slice against botorch_tpu on the
CPU: `utils/multi_objective.py`, `test_functions/multi_objective.py`,
multi-output MC sampling (`posteriors/gaussian.py`, base samples,
`convert.py`) and `acquisition/multi_objective.py`.

Inputs come from a numpy seed and go through both packages. Tolerances:
* the Pareto mask exactly; the staircase, cells, hypervolume and
  reference point within 1e-6 relative (float32, the same operations);
* `_hvi_from_cells` values within 1e-5 of the largest cell-volume term
  and gradients within 1e-5 of the largest entry: an inclusion-exclusion
  sum over up to 7 subsets and 13 cells, summed in another order;
* the acquisitions as `test_torch_mc_acquisition.py` holds qLogNEI:
  values within 1e-4 relative (+1e-5), gradients within 3e-3 of their
  largest entry (a float32 joint posterior over up to 19 points through a
  jittered Cholesky factor), on a model of that test's conditioning
  (noise 1e-2). The exception is the plain (unsmoothed) qNEHVI, the
  mean of per-sample HVIs of objectives on a scale of ~100: at one of its
  five candidate sets the joint covariance is ill-conditioned, and the
  pending point's sample moves by 1% between float32 and float64. There
  each package's float32 value lies 1.5e-4 (the port) and 5.4e-4 (the JAX
  package) from the port's float64 value, and its gradient 6.7e-3 and
  3.1e-2 of the largest entry. So the plain qNEHVI is held to the JAX
  package within 1e-3 relative and 5e-2 of the largest gradient entry,
  and to the port's own float64 evaluation within 3e-4 and 1.5e-2 (twice
  the port's measured float32 error). The JAX side maps one candidate set
  at a time (`jax.vmap`), the port evaluates the t-batch at once; all JAX
  quantities are compiled in one call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import monte_carlo as jmc
from botorch_tpu.acquisition import multi_objective as jmo
from botorch_tpu.models import gp as jgp
from botorch_tpu.test_functions.multi_objective import BraninCurrin as JBraninCurrin
from botorch_tpu.utils import multi_objective as jmu
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import monte_carlo as tmc
from botorch_tpu_torch.acquisition import multi_objective as tmo
from botorch_tpu_torch.models import gp as tgp
from botorch_tpu_torch.settings import make_generator
from botorch_tpu_torch.test_functions.multi_objective import BraninCurrin
from botorch_tpu_torch.utils import multi_objective as tmu
from _torch_threads import _one_torch_thread  # noqa: F401


CAP, NV, D, NMC = 16, 12, 2, 16
REF = np.array([-18.0, -6.0], np.float32)  # BraninCurrin(negate=True).ref_point


def _fronts(nmc=5, n=9, seed=0):
    """Batched point sets `(nmc, n, 2)` with rows at `ref` (padding), exact
    duplicates and points below `ref`."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(nmc, n, 2)).astype(np.float32)
    ref = np.array([-1.5, -1.2], np.float32)
    Y[:, -2:] = ref  # padding rows
    Y[:, 3] = Y[:, 1]  # an exact duplicate
    Y[0, 4] = ref - 1.0  # below the reference point
    Y[1, 5] = [Y[1, 0, 0], -1.0]  # ties in objective 0
    return Y, ref


UTILS = ["staircase", "hypervolume_2d", "nondominated_cells", "dominated_cells",
         "infer_reference_point", "hypervolume"]
CAP_REF = np.array([np.inf, -0.5], np.float32)
REF_KW = ({}, {"max_ref_point": CAP_REF}, {"max_ref_point": CAP_REF, "scale_max_ref_point": True})


@pytest.fixture(scope="module")
def utilities_reference():
    """Every JAX utility output for `_fronts()`, from one compiled call."""
    Y, ref = _fronts()
    front = Y[0][np.asarray(jax.jit(jmu.is_non_dominated)(jnp.asarray(Y[0])))]

    @jax.jit
    def run(Y, ref, front):
        out = {
            "nd": jmu.is_non_dominated(Y), "nd_all": jmu.is_non_dominated(Y, deduplicate=False),
            "staircase": jmu._pareto_staircase_2d(Y, ref),
            "hypervolume_2d": jmu.hypervolume_2d(Y, ref),
            "nondominated_cells": jnp.concatenate(
                jmu.nondominated_hypercell_bounds_2d(Y, ref, clip_max=1e8)),
            "dominated_cells": jnp.concatenate(jmu.dominated_hypercell_bounds_2d(Y, ref)),
        }
        for i, kw in enumerate(REF_KW):
            out[f"ref{i}"] = jmu.infer_reference_point(
                front, **{k: jnp.asarray(v) if k == "max_ref_point" else v
                          for k, v in kw.items()})
        return out

    return Y, ref, front, run(jnp.asarray(Y), jnp.asarray(ref), jnp.asarray(front))


@pytest.mark.parametrize("name", UTILS)
def test_two_objective_utilities_match_reference(utilities_reference, name):
    Y, ref, front, want = utilities_reference
    Yt, reft = torch.tensor(Y), torch.tensor(ref)
    np.testing.assert_array_equal(tmu.is_non_dominated(Yt).numpy(), np.asarray(want["nd"]))
    np.testing.assert_array_equal(tmu.is_non_dominated(Yt, deduplicate=False).numpy(),
                                  np.asarray(want["nd_all"]))
    if name == "infer_reference_point":
        for i, kw in enumerate(REF_KW):
            got = tmu.infer_reference_point(
                torch.tensor(front),
                **{k: torch.tensor(v) if k == "max_ref_point" else v for k, v in kw.items()})
            np.testing.assert_allclose(got.numpy(), np.asarray(want[f"ref{i}"]), rtol=1e-6)
        return
    if name == "hypervolume":
        for s in range(Y.shape[0]):
            assert tmu.hypervolume(Y[s], ref) == pytest.approx(
                float(want["hypervolume_2d"][s]), rel=1e-6)
        with pytest.raises(NotImplementedError, match="15b"):
            tmu.hypervolume(np.zeros((3, 3), np.float32), np.zeros(3, np.float32))
        return
    got = {
        "staircase": lambda: tmu._pareto_staircase_2d(Yt, reft),
        "hypervolume_2d": lambda: tmu.hypervolume_2d(Yt, reft),
        "nondominated_cells": lambda: torch.cat(
            tmu.nondominated_hypercell_bounds_2d(Yt, reft, clip_max=1e8)),
        "dominated_cells": lambda: torch.cat(tmu.dominated_hypercell_bounds_2d(Yt, reft)),
    }[name]()
    np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-6)


def test_branin_currin_matches_reference():
    X = np.random.default_rng(1).uniform(size=(64, 2)).astype(np.float32)
    X[0, 1] = 0.0  # Currin's guarded branch
    X[1] = [0.0, 1.0]
    for negate in (False, True):
        tp, jp = BraninCurrin(negate=negate), JBraninCurrin(negate=negate)
        np.testing.assert_allclose(tp(torch.tensor(X)).numpy(),
                                   np.asarray(jax.jit(jp.__call__)(jnp.asarray(X))),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(tp.ref_point.numpy(), np.asarray(jp.ref_point))
        assert tp.max_hv == jp.max_hv and tp.num_objectives == 2


HVI_CASES = [(q, tau) for q in (1, 2, 3) for tau in (0.0, 1e-3)]


def _cells_and_F(q, seed=0):
    """Cells of a 2-d front for 4 MC samples (with padding rows at `ref`)
    and candidate samples `(4, 3, q, 2)`, with ties: two equal candidates
    (q >= 2) and a candidate value equal to a cell's upper bound."""
    rng = np.random.default_rng(seed)
    front = rng.normal(size=(4, 6, 2)).astype(np.float32)
    ref = np.array([-2.0, -2.0], np.float32)
    front[:, -1] = ref
    lo, up = tmu.nondominated_hypercell_bounds_2d(torch.tensor(front), torch.tensor(ref),
                                                  clip_max=1e8)
    F = rng.normal(size=(4, 3, q, 2)).astype(np.float32)
    if q >= 2:
        F[:, 0, 1] = F[:, 0, 0]
    F[:, 1, 0, 1] = up[:, 2, 1].numpy()
    return lo.numpy(), up.numpy(), F


@pytest.fixture(scope="module")
def hvi_reference():
    """JAX `_hvi_from_cells` values and gradients of every case, from one
    compiled call; the cells broadcast over the t-batch dim, as the
    acquisitions broadcast them."""
    inputs = {case: _cells_and_F(case[0]) for case in HVI_CASES}

    @jax.jit
    def run(inputs):
        out = {}
        for (q, tau), (lo, up, F) in inputs.items():
            mj, sj = jmo._subset_masks(q)

            def f(F, lo=lo, up=up, mj=mj, sj=sj, tau=tau):
                return jmo._hvi_from_cells(F, lo[:, None], up[:, None], mj, sj, smooth_tau=tau)

            out[(q, tau)] = (f(F), jax.grad(lambda F: jnp.sum(f(F)))(F))
        return out

    return inputs, run({k: tuple(map(jnp.asarray, v)) for k, v in inputs.items()})


@pytest.mark.parametrize("q,tau", HVI_CASES)
def test_hvi_from_cells_values_and_grads(hvi_reference, q, tau):
    inputs, want = hvi_reference
    lo, up, F = inputs[(q, tau)]
    vj, gj = want[(q, tau)]
    mj, sj = jmo._subset_masks(q)
    mt, st = tmo._subset_masks(q)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    Ft = torch.tensor(F, requires_grad=True)
    vt = tmo._hvi_from_cells(Ft, torch.tensor(lo)[:, None], torch.tensor(up)[:, None], mt, st,
                             smooth_tau=tau)
    (gt,) = torch.autograd.grad(vt.sum(), Ft)
    assert vt.shape == (4, 3)
    scale = float(np.abs(np.asarray(vj)).max()) + 1.0
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=0, atol=1e-5 * scale)
    gscale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5 * gscale + 1e-7)
    if q >= 2:
        # the tie of candidates 0 and 1 splits the subset-min's gradient evenly
        np.testing.assert_allclose(gt[:, 0, 0].numpy(), gt[:, 0, 1].numpy(), rtol=1e-6)


# --------------------------------------------------------------------------- #
# multi-output models, MC sampling and the acquisitions
# --------------------------------------------------------------------------- #
PARAMS = {"mean": np.array([0.1, -0.2], np.float32),
          "raw_lengthscale": np.log(np.array([[0.3, 0.5], [0.4, 0.25]], np.float32)),
          "raw_outputscale": np.zeros(2, np.float32),
          "raw_noise": np.log(np.array([1e-2, 1e-2], np.float32))}
# the acquisitions' reference point: 6 of the 12 points lie above it, so
# the cells of the observed front and of the baseline samples matter (all
# 12 lie below BraninCurrin's own)
REF_ACQ = np.array([-150.0, -11.0], np.float32)


def _below(threshold):
    """Constraint `y_1 <= threshold` (both packages)."""
    return lambda s: s[..., 1] - threshold


# name, class name, q, pending points, cells ("pre": built once; "eval":
# at every evaluation; None: the observed front's, for qEHVI), constraints.
# The constrained case takes eta = 0.1: at the default 1e-3 the smooth
# feasibility of a sample turns float32 rounding of ~1e-5 into ~1e-2.
CASES = [
    ("qNEHVI", "qNoisyExpectedHypervolumeImprovement", 2, 1, "pre", ()),
    ("qLogNEHVI", "qLogNoisyExpectedHypervolumeImprovement", 2, 1, "pre", ()),
    ("qLogNEHVI-eval-cells-constrained", "qLogNoisyExpectedHypervolumeImprovement", 2, 0, "eval",
     (_below(-2.0),)),
    ("qLogEHVI", "qLogExpectedHypervolumeImprovement", 2, 1, None, ()),
]


# the loop's acquisition and its plain variant are compared with their
# gradients; the other cases, values only (each gradient costs the JAX
# side a compile of its backward)
WITH_GRADIENTS = ("qNEHVI", "qLogNEHVI")


def _data():
    """12 BraninCurrin points in a 16-row buffer, 5 candidate sets per
    case, one pending point and base samples (numpy)."""
    rng = np.random.default_rng(0)
    X = np.zeros((CAP, D), np.float32)
    X[:NV] = rng.uniform(size=(NV, D))
    Y = np.zeros((CAP, 2), np.float32)
    Y[:NV] = BraninCurrin(negate=True)(torch.tensor(X[:NV])).numpy()
    mask = np.arange(CAP) < NV
    P = rng.uniform(size=(1, D)).astype(np.float32)
    Xq = {c[0]: rng.uniform(size=(5, c[2], D)).astype(np.float32) for c in CASES}
    Xq["posterior"] = rng.uniform(size=(3, 5, D)).astype(np.float32)
    Xq["rung"] = np.stack([X[:5], X[1:6]])  # on the training points
    base = rng.standard_normal(size=(NMC, CAP + 3, 2)).astype(np.float32)
    return X, Y, mask, P, Xq, base


def _kw(case, X, Y, mask, P, Xq, base, pkg):
    """Constructor arguments of a case's acquisition in package `pkg`
    (`jnp.asarray` or `torch.tensor` as `arr`), each package building its
    own cells."""
    name, cls_name, q, n_pending, cells, constraints = case
    mo, mu, arr = pkg
    masks, signs = mo._subset_masks(q + n_pending)
    kw = dict(ref_point=arr(REF_ACQ), masks=masks, signs=signs, constraints=constraints)
    if constraints:
        kw["eta"] = 0.1
    if n_pending:
        kw["X_pending"] = arr(P)
    noisy = cells is not None
    nb = CAP if noisy else 0
    kw["base_samples"] = arr(base[:, : nb + q + n_pending])
    if noisy:
        kw.update(X_baseline=arr(X), baseline_mask=arr(mask))
    else:
        front = Y[mask][np.asarray(tmu.is_non_dominated(torch.tensor(Y[mask])))]
        kw["cell_lower"], kw["cell_upper"] = mu.nondominated_hypercell_bounds_2d(
            arr(front[(front > REF_ACQ).all(-1)]), arr(REF_ACQ), clip_max=mo.CLIP_MAX)
    return kw


@pytest.fixture(scope="module")
def reference():
    """The two-output GP in both packages with the same (converted)
    hyperparameters, and every JAX quantity the tests below compare, from
    one compiled call: the model's loss and train root, the posterior of 3
    candidate sets, and each case's values and gradients (mapped over the
    candidate sets)."""
    X, Y, mask, P, Xq, base = _data()
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y), mask=jnp.asarray(mask),
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in PARAMS.items()}))
    tm = tgp.make_gp(X, Y, mask=mask, device="cpu", params=convert.gp_params_from_numpy(PARAMS))
    rung_params = dict(PARAMS, raw_noise=np.log(np.array([0.5, 1e-8], np.float32)))
    jm_rung = jm.replace(params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in rung_params.items()}),
                         _cache=None)
    tm_rung = tm.replace(params=convert.gp_params_from_numpy(rung_params))

    @jax.jit
    def run(jm, Xq):
        out = {"loss": jm.map_objective(jm.params), "root": jm.train_chol()}

        def post(x):
            p = jm.posterior(x)
            return p.mean, p.cov, p.scale_tril, p.rsample_from_base_samples(
                jnp.asarray(base[:, :5]))

        out["posterior"] = jax.vmap(post)(Xq["posterior"])
        out["rung_tril"] = jax.vmap(lambda x: jm_rung.posterior(x).scale_tril)(Xq["rung"])
        cache = jm.train_chol()
        for case in CASES:
            kw = _kw(case, X, Y, mask, P, Xq, base, (jmo, jmu, jnp.asarray))
            if case[4] == "pre":
                kw["cell_lower"], kw["cell_upper"] = jmo.make_in_graph_nehvi_cells(
                    jm, cache, kw["X_baseline"], jnp.asarray(base[:, :CAP]), jnp.asarray(REF_ACQ),
                    baseline_mask=jnp.asarray(mask))
            acqf = getattr(jmo, case[1])(model=jm, cache=cache, **kw)
            if case[0] in WITH_GRADIENTS:
                out[case[0]] = jax.vmap(jax.value_and_grad(acqf))(Xq[case[0]])
            else:
                out[case[0]] = (jax.vmap(acqf)(Xq[case[0]]), None)
        return out

    data = (X, Y, mask, P, Xq, base, tm_rung)
    return jm, tm, data, run(jm, {k: jnp.asarray(v) for k, v in Xq.items()})


def _port_acqf(tm, data, case):
    X, Y, mask, P, Xq, base, _ = data
    kw = _kw(case, X, Y, mask, P, Xq, base, (tmo, tmu, torch.tensor))
    cache = tm.train_chol()
    if case[4] == "pre":
        kw["cell_lower"], kw["cell_upper"] = tmo.make_in_graph_nehvi_cells(
            tm, cache, kw["X_baseline"], torch.tensor(base[:, :CAP]), torch.tensor(REF_ACQ),
            baseline_mask=torch.tensor(mask))
    return getattr(tmo, case[1])(model=tm, cache=cache, **kw)


def _close(got, want, rel):
    """max |got - want| within `rel` of max |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def test_multi_output_params_cross_and_fit_the_same_model(reference):
    """A JAX multi-output `GPParams` (one set per output) crosses, and the
    two models' MAP loss and train root agree: the loss within 1e-4
    relative, the root within 1e-4 of its largest entry (a float32
    Cholesky, cf. `test_torch_gp.py`)."""
    jm, tm, _, want = reference
    back = convert.gp_params_to_numpy(tm.params)
    for f in convert.GPParams.FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jm.params, f)))
    assert tm.num_outputs == 2 and tm.params.raw_lengthscale.shape == (2, D)
    np.testing.assert_allclose(float(tm.map_objective(tm.params)), float(want["loss"]), rtol=1e-4)
    for a, b in zip(tm.train_chol(), want["root"]):
        _close(a.numpy(), b, 1e-4)


def test_two_output_posterior_samples_match_reference(reference):
    """The joint posterior of 3 candidate sets of 5 points at m = 2: mean,
    covariance, `scale_tril (b, 2, q, q)` and draws from `(nmc, q, 2)` base
    samples, each within 1e-4 of its largest entry."""
    _, tm, data, want = reference
    Xq, base = data[4], data[5]
    pt = tm.posterior(torch.tensor(Xq["posterior"]))
    mean, cov, L, draws = want["posterior"]
    _close(pt.mean.numpy(), mean, 1e-4)
    _close(pt.cov.numpy(), cov, 1e-4)
    assert pt.scale_tril.shape == (3, 2, 5, 5)
    _close(pt.scale_tril.numpy(), L, 1e-4)
    got = pt.rsample_from_base_samples(torch.tensor(base[:, :5])[:, None])  # (nmc, b, q, m)
    _close(got.numpy(), np.moveaxis(np.asarray(draws), 0, 1), 1e-4)


def test_one_jitter_rung_serves_both_outputs_of_a_set(reference):
    """At 5 training points with output 1's noise at 1e-8, output 1's
    posterior covariance factors only at the ladder's rung 5 (jitter 1.0
    times its mean diagonal) and output 0's at rung 0. The JAX package
    factors each set's `(m, q, q)` covariance at one rung, so output 0 of
    that set takes rung 5 too: the port's output-0 factor is the JAX one
    (within 1e-4 of its largest entry) and far from output 0's own rung-0
    factor."""
    from botorch_tpu_torch.ops.chol import cholesky, jitter_rung

    _, _, data, want = reference
    tm_rung = data[6]
    pt = tm_rung.posterior(torch.tensor(data[4]["rung"]))
    assert jitter_rung(pt.cov, batch_dims=2).tolist() == [[0, 5], [0, 5]]
    assert jitter_rung(pt.cov, batch_dims=1).tolist() == [5, 5]
    L0 = pt.scale_tril[:, 0]
    _close(L0.numpy(), np.asarray(want["rung_tril"])[:, 0], 1e-4)
    own = cholesky(pt.cov[:, 0])
    assert float((L0 - own).abs().max()) > 0.1 * float(own.abs().max())


def test_fresh_base_samples_for_two_outputs():
    """`draw_fresh_base_samples(capacity + q, 2, ...)` at the MO loop's Sobol
    seed is the seeded engine shifted by the generator's words, as
    `base_samples_from_words` gives it (held to the JAX package at m = 2 in
    `test_torch_mc_acquisition.py`)."""
    q_total, n = 14, 32
    own = tmc.draw_fresh_base_samples(q_total, 2, n, make_generator(3, "cpu"), seed=23)
    words = torch.randint(0, 1 << 32, (q_total * 2,), generator=make_generator(3, "cpu"),
                          dtype=torch.int64)
    assert own.shape == (n, q_total, 2) and torch.isfinite(own).all()
    assert torch.equal(own, tmc.base_samples_from_words(q_total, 2, n, words, seed=23))
    assert abs(float(own.mean())) < 0.05 and abs(float(own.std()) - 1.0) < 0.05


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_values_and_grads_against_reference(reference, case):
    _, tm, data, want = reference
    vj, gj = want[case[0]]
    at = _port_acqf(tm, data, case)
    Xt = torch.tensor(data[4][case[0]], requires_grad=True)
    vt = at(Xt)
    (gt,) = torch.autograd.grad(vt.sum(), Xt)
    assert vt.shape == (5,) and np.isfinite(np.asarray(vj)).all()
    rtol, gtol = (1e-3, 5e-2) if case[0] == "qNEHVI" else (1e-4, 3e-3)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=rtol, atol=1e-5)
    assert torch.isfinite(gt).all()
    if gj is None:
        return
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=gtol * scale + 1e-7)
    if case[0] == "qNEHVI":
        v64, g64 = _port_float64(data, case)
        np.testing.assert_allclose(vt.detach().double().numpy(), v64, rtol=3e-4)
        np.testing.assert_allclose(gt.double().numpy(), g64, rtol=0,
                                   atol=1.5e-2 * np.abs(g64).max())


def _port_float64(data, case):
    """The port's value and gradient of a case in float64."""
    X, Y, mask = data[:3]
    f64 = torch.float64
    tm = tgp.make_gp(X, Y, mask=mask, device="cpu", dtype=f64,
                     params=convert.gp_params_from_numpy(PARAMS, dtype=f64))
    at = _port_acqf(tm, data, case)
    cast = {k: getattr(at, k).to(f64) for k in ("base_samples", "ref_point", "cell_lower",
                                                 "cell_upper", "X_pending", "X_baseline")
            if getattr(at, k, None) is not None}
    import dataclasses

    at = dataclasses.replace(at, **cast)
    Xt = torch.tensor(data[4][case[0]], dtype=f64, requires_grad=True)
    v = at(Xt)
    (g,) = torch.autograd.grad(v.sum(), Xt)
    return v.detach().numpy(), g.numpy()


def test_a_candidate_set_does_not_see_the_rest_of_the_batch(reference):
    """qLogNEHVI reduces over the MC samples only: a t-batch element's value
    is its value alone, also beside a set on the baseline points (a high
    jitter rung) and a set equal to the pending point (subset-min ties).
    It fails if the reduction runs over the t-batch."""
    _, tm, data, _ = reference
    X = data[0]
    at = _port_acqf(tm, data, CASES[1])
    Xq = np.random.default_rng(4).uniform(size=(5, 2, D)).astype(np.float32)
    Xq[2] = X[:2]
    Xq[3, 1] = data[3][0]
    batched = at(torch.tensor(Xq))
    alone = torch.cat([at(torch.tensor(Xq[i:i + 1])) for i in range(5)])
    torch.testing.assert_close(batched, alone, rtol=1e-6, atol=1e-6)
    assert len(set(batched.tolist())) == 5
    assert at(torch.tensor(Xq[0])).shape == ()


def test_precomputed_cells_are_the_evaluation_time_cells(reference):
    """Unconstrained qLogNEHVI with the cells built once equals the one that
    builds them at every evaluation (the baseline block of the joint
    samples does not depend on the candidates); the constrained one refuses
    precomputed cells."""
    import dataclasses

    _, tm, data, _ = reference
    at = _port_acqf(tm, data, CASES[1])
    at_eval = dataclasses.replace(at, cell_lower=None, cell_upper=None)
    Xq = torch.tensor(data[4][CASES[1][0]])
    torch.testing.assert_close(at(Xq), at_eval(Xq), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="constrained"):
        dataclasses.replace(at, constraints=(_below(0.0),))(Xq)


def test_make_qnehvi_and_make_qehvi(reference):
    """The builders draw the JAX package's qMC base samples and build the
    cells their classes use; the options not ported raise."""
    _, tm, data, _ = reference
    X, Y, mask = data[:3]
    at = tmo.make_qnehvi(tmo.qLogNoisyExpectedHypervolumeImprovement, tm, REF_ACQ, q=2,
                         X_baseline=torch.tensor(X), num_samples=NMC, seed=5,
                         baseline_mask=torch.tensor(mask))
    base = np.asarray(jax.jit(jmc._draw_base_samples, static_argnums=(0, 1, 2, 3))(
        CAP + 2, 2, NMC, 5))
    np.testing.assert_allclose(at.base_samples.numpy(), base, rtol=1e-6, atol=1e-6)
    lo, up = tmo.make_in_graph_nehvi_cells(tm, at.cache, torch.tensor(X),
                                           at.base_samples[:, :CAP], torch.tensor(REF_ACQ),
                                           baseline_mask=torch.tensor(mask))
    assert torch.equal(at.cell_lower, lo) and torch.equal(at.cell_upper, up)
    assert at.cell_lower.shape == (NMC, CAP + 1, 2)
    et = tmo.make_qehvi(tmo.qExpectedHypervolumeImprovement, tm, REF_ACQ, q=1,
                        Y_baseline=torch.tensor(Y[mask]), num_samples=NMC, seed=2)
    front = Y[mask][tmu.is_non_dominated(torch.tensor(Y[mask])).numpy()]
    front = front[(front > REF_ACQ).all(-1)]
    lo, up = tmu.nondominated_hypercell_bounds_2d(torch.tensor(front), torch.tensor(REF_ACQ),
                                                  clip_max=tmo.CLIP_MAX)
    assert torch.equal(et.cell_lower, lo) and torch.equal(et.cell_upper, up)
    assert et(torch.tensor(X[:3, None])).shape == (3,)
    with pytest.raises(NotImplementedError, match="item 19"):
        tmo.make_qnehvi(tmo.qLogNoisyExpectedHypervolumeImprovement, tm, REF_ACQ, q=2,
                        X_baseline=torch.tensor(X), prune_baseline=True)
    three = tgp.make_gp(X, np.concatenate([Y, Y[:, :1]], -1), mask=mask, device="cpu")
    with pytest.raises(NotImplementedError, match="15b"):
        tmo.make_qnehvi(tmo.qLogNoisyExpectedHypervolumeImprovement, three,
                        np.zeros(3, np.float32), q=1, X_baseline=torch.tensor(X))
