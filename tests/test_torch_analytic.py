"""Port parity for `acquisition/analytic.py`: every class of the BO loop's
`_ANALYTIC` table against botorch_tpu on the same model, values and
gradients in X, maximizing and minimizing.

The port evaluates a batch `X (b, 1, d)` where the reference vmaps over
`(1, d)`. Tolerances: values rtol 3e-4, gradients 3e-3 of their scale.
Both packages go through the float32 posterior of a GP whose train
covariance has condition number ~1.5e3 (noise 1e-2), so `K^-1 y` and the
cancelling `k(x,x) - v^T v` carry ~cond * eps ~ 1e-4 relative rounding;
deep in the tail log EI ~ -u^2/2 doubles that, and a gradient is a
difference of such terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.acquisition import analytic as ja
from botorch_tpu.models import gp as jgp
from botorch_tpu_torch import convert
from botorch_tpu_torch.acquisition import analytic as ta
from botorch_tpu_torch.models import gp as tgp
from _torch_threads import _one_torch_thread  # noqa: F401


NAMES = ["EI", "LogEI", "PI", "LogPI", "UCB", "PosteriorMean"]


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(15, 2)).astype(np.float32)
    Y = (np.sin(6 * X[:, 0]) + X[:, 1]).astype(np.float32)
    pn = {"mean": np.array([0.1], np.float32),
          "raw_lengthscale": np.log(np.array([[0.3, 0.5]], np.float32)),
          "raw_outputscale": np.zeros(1, np.float32),
          "raw_noise": np.log(np.array([1e-2], np.float32))}
    jm = jgp.make_gp(jnp.asarray(X), jnp.asarray(Y)[:, None],
                     params=jgp.GPParams(**{k: jnp.asarray(v) for k, v in pn.items()}))
    tm = tgp.make_gp(X, Y[:, None], device="cpu", params=convert.gp_params_from_numpy(pn))
    return jm, tm, float(Y.max())


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_values_and_grads(models, name, maximize):
    jm, tm, best = models
    kw = {}
    if name in ("EI", "LogEI", "PI", "LogPI"):
        kw["best_f"] = best if maximize else -best + 1.5
    if name == "UCB":
        kw["beta"] = 2.0
    acq_t = ta.make_acqf(name, tm, maximize=maximize, **kw)
    acq_j = ja.make_acqf(name, jm, maximize=maximize, **kw)
    Xq = np.random.default_rng(1).uniform(size=(64, 1, 2)).astype(np.float32)
    Xt = torch.tensor(Xq, requires_grad=True)
    vt = acq_t(Xt)
    (gt,) = torch.autograd.grad(vt.sum(), Xt)
    vj, gj = jax.jit(jax.vmap(jax.value_and_grad(acq_j)))(jnp.asarray(Xq))
    assert vt.shape == (64,)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=3e-4, atol=1e-5)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=3e-3, atol=3e-3 * scale)


def test_log_ei_far_from_incumbent_has_gradient(models):
    _, tm, best = models
    acq = ta.LogExpectedImprovement(model=tm, cache=tm.train_chol(), best_f=best + 50.0)
    X = torch.rand(16, 1, 2, generator=torch.Generator().manual_seed(2), requires_grad=True)
    v = acq(X)
    (g,) = torch.autograd.grad(v.sum(), X)
    assert torch.isfinite(v).all() and torch.isfinite(g).all() and (g.abs() > 0).any()
