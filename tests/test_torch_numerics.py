"""Port parity: `utils/safe_math`, `utils/probability`, `utils/transforms`
of botorch_tpu_torch against botorch_tpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Values
and gradients are compared in float32 at rtol 2e-6 / atol 1e-6 unless a
case says otherwise: both sides evaluate the same formulas with
correctly-rounded-to-a-few-ulp CPU special functions, so a mismatch above
a few ulps is a porting error, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.utils import probability as jp
from botorch_tpu.utils import safe_math as jsm
from botorch_tpu.utils import transforms as jt
from botorch_tpu_torch.utils import probability as tp
from botorch_tpu_torch.utils import safe_math as tsm
from botorch_tpu_torch.utils import transforms as tt
from _torch_threads import _one_torch_thread  # noqa: F401


RTOL, ATOL = 2e-6, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _grid(lo, hi, n=257, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.linspace(lo, hi, n), rng.uniform(lo, hi, n)])
    return x.astype(np.float32)


def _value_and_grad(tf, jf, x):
    xt = torch.tensor(x, requires_grad=True)
    yt = tf(xt)
    (gt,) = torch.autograd.grad(yt.sum(), xt)
    yj, gj = jax.jit(jax.vmap(jax.value_and_grad(jf)))(jnp.asarray(x))
    return yt, gt, yj, gj


# float32 tolerances (value rtol, grad rtol, grad atol). Looser entries are
# where a float32 rounding of ~1e-7 in exp/erfc is amplified by the
# function itself: erfcx's derivative 2x erfcx(x) - 2/sqrt(pi) cancels
# ~2x^2-fold, and below u = -1 the LogEI helper takes log1mexp(w) with
# w ~ -1/u^2, a further 1/|w| ~ u^2; at u = -8 the two packages' float32
# gradients differ by ~1e-4 relative while both agree with their float64
# values. The float64 runs below hold the algorithm itself at 1e-9.
T, L1, L2 = (RTOL, RTOL, ATOL), (2e-5, 2e-5, ATOL), (2e-5, 2e-3, 1e-5)
ELEMENTWISE = [
    # (name, torch fn, jax fn, lo, hi, float32 tolerances)
    ("log1mexp", tsm.log1mexp, jsm.log1mexp, -30.0, -1e-3, L1),
    ("log1pexp", tsm.log1pexp, jsm.log1pexp, -30.0, 40.0, T),
    ("logexpit", tsm.logexpit, jsm.logexpit, -30.0, 30.0, T),
    ("log_softplus", tsm.log_softplus, jsm.log_softplus, -40.0, 20.0, T),
    ("fatplus", tsm.fatplus, jsm.fatplus, -50.0, 50.0, T),
    ("log_fatplus", tsm.log_fatplus, jsm.log_fatplus, -50.0, 50.0, T),
    ("fatmoid", tsm.fatmoid, jsm.fatmoid, -20.0, 20.0, T),
    ("log_fatmoid", tsm.log_fatmoid, jsm.log_fatmoid, -20.0, 20.0, T),
    ("ndtr", tp.ndtr, jp.ndtr, -8.0, 8.0, T),
    ("phi", tp.phi, jp.phi, -8.0, 8.0, T),
    ("log_phi", tp.log_phi, jp.log_phi, -30.0, 30.0, T),
    ("erfcx_neg", tp.erfcx, jp.erfcx, -3.0, 0.0, T),
    ("erfcx_pos", tp.erfcx, jp.erfcx, 0.0, 40.0, (2e-5, 2e-5, 4e-6)),
    ("erfcx_tail", tp.erfcx, jp.erfcx, 6.0, 1e4, L1),
    ("log_erfc", tp.log_erfc, jp.log_erfc, -5.0, 30.0, L1),
    ("log_erfcx", tp.log_erfcx, jp.log_erfcx, -5.0, 30.0, L2),
    ("log_ndtr", tp.log_ndtr, jp.log_ndtr, -40.0, 8.0, L1),
    ("ei_helper", tp.ei_helper, jp.ei_helper, -8.0, 8.0, T),
    ("log_ei_helper", tp.log_ei_helper, jp.log_ei_helper, -40.0, 8.0, L2),
    ("log_ei_helper_far", tp.log_ei_helper, jp.log_ei_helper, -1e6, -1e2, L2),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ELEMENTWISE, ids=[c[0] for c in ELEMENTWISE])
def test_elementwise_values_and_grads(case, dtype):
    _, tf, jf, lo, hi, (vrtol, grtol, gatol) = case
    x = _grid(lo, hi).astype(dtype)
    if dtype == "float64":
        vrtol, grtol, gatol = 1e-10, 1e-9, 1e-12
    with jax.enable_x64(dtype == "float64"):
        yt, gt, yj, gj = _value_and_grad(tf, jf, x)
    assert yt.dtype == getattr(torch, dtype) and np.asarray(yj).dtype == dtype
    _close(yt, yj, rtol=vrtol, atol=ATOL if dtype == "float32" else 1e-12)
    _close(gt, gj, rtol=grtol, atol=gatol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_log_ei_helper_extreme_tail_finite(dtype):
    # float32 u^2 overflows beyond |u| ~ 1.8e19 (both packages give -inf)
    x = np.array([-1e18, -1e10, -1e4, -1e3 + 1.0, 1e3], dtype)
    with jax.enable_x64(dtype == "float64"):
        yt, gt, yj, gj = _value_and_grad(tp.log_ei_helper, jp.log_ei_helper, x)
    assert torch.isfinite(yt).all() and torch.isfinite(gt).all()
    _close(yt, yj, rtol=2e-5 if dtype == "float32" else 1e-10)


@pytest.mark.parametrize("fn", ["logsumexp", "logmeanexp", "fatmax", "fatmin",
                                "smooth_amax", "smooth_amin"])
@pytest.mark.parametrize("axis", [-1, 0, (0, 2)])
def test_reductions(fn, axis):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32) * 4
    if not fn.startswith("fat"):
        # inf-robust paths; the reference's fatmax takes a NaN gradient from
        # a lone -inf, in eager and jitted JAX at different places
        x[0, 0, 0] = -np.inf
    xt = torch.tensor(x, requires_grad=True)
    yt = getattr(tsm, fn)(xt, axis)
    (gt,) = torch.autograd.grad(yt.sum(), xt)
    jf = getattr(jsm, fn)
    yj, gj = jax.jit(jax.value_and_grad(lambda a: jf(a, axis).sum()))(jnp.asarray(x))
    _close(yt.sum(), yj, rtol=1e-5)
    _close(gt, gj, rtol=1e-5, atol=1e-6)


def test_all_neg_inf_slice_has_finite_grad():
    x = torch.full((2, 3), -torch.inf, requires_grad=True)
    y = tsm.logsumexp(x, dim=-1)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isneginf(y).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("fn", ["logplusexp", "logdiffexp", "fatmaximum", "fatminimum"])
def test_binary(fn):
    rng = np.random.default_rng(5)
    a = rng.normal(size=64).astype(np.float32) * 3
    b = a + np.abs(rng.normal(size=64)).astype(np.float32) + 0.1
    yt = getattr(tsm, fn)(torch.tensor(a), torch.tensor(b))
    yj = jax.jit(getattr(jsm, fn))(jnp.asarray(a), jnp.asarray(b))
    _close(yt, yj, rtol=1e-5)



def test_sigmoid_variants():
    x = _grid(-20, 20)
    for log in (False, True):
        for fat in (False, True):
            _close(tsm.sigmoid(torch.tensor(x), log=log, fat=fat),
                   jax.jit(jsm.sigmoid, static_argnums=(1, 2))(jnp.asarray(x), log, fat),
                   rtol=1e-5)


def test_transforms():
    rng = np.random.default_rng(11)
    bounds = np.array([[-5.0, 0.0, 2.0], [10.0, 15.0, 3.0]], np.float32)
    X = rng.uniform(size=(7, 3)).astype(np.float32)
    Xt = torch.tensor(X)
    _close(tt.unnormalize(Xt, bounds), jt.unnormalize(jnp.asarray(X), jnp.asarray(bounds)))
    Z = np.asarray(jt.unnormalize(jnp.asarray(X), jnp.asarray(bounds)))
    _close(tt.normalize(torch.tensor(Z), torch.tensor(bounds)),
           jt.normalize(jnp.asarray(Z), jnp.asarray(bounds)))
    Y = rng.normal(size=(9, 2)).astype(np.float32) * 5 + 3
    _close(tt.standardize(torch.tensor(Y)), jt.standardize(jnp.asarray(Y)), rtol=1e-5)
    _close(tt.standardize(torch.tensor(Y[:, 0])), jt.standardize(jnp.asarray(Y[:, 0])), rtol=1e-5)
    const = np.ones((4, 1), np.float32)
    _close(tt.standardize(torch.tensor(const)), jt.standardize(jnp.asarray(const)))
