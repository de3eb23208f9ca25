"""Port parity for kernel K2's module: the raw kernels of
`botorch_tpu_torch/ops/kernels.py` (K2's plain version) against
`botorch_tpu.ops.kernels.KERNELS`, values and gradients, including
coincident points (the Matern sqrt at d^2 = 0), and the wrapper's CPU
routing and batch handling. The CUDA kernel itself is checked on the card
(`test_torch_cuda.py`, `chip_smoke.py`).

Tolerances: float32 values at rtol 1e-5 / atol 1e-6 (a d-term dot product
rounded in two orders); float64 at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from botorch_tpu.ops import kernels as jk
from botorch_tpu_torch.ops import kernel_matrix as tkm
from botorch_tpu_torch.ops import kernels as tk
from _torch_threads import _one_torch_thread  # noqa: F401


KINDS = ["rbf", "matern52", "matern32", "matern12"]


def _inputs(n, m, d, batch=(), seed=0, coincident=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(dtype)
    z = x.copy() if coincident else rng.uniform(size=(*batch, m, d)).astype(dtype)
    ls = rng.uniform(0.1, 1.5, size=(*batch, d)).astype(dtype)
    return x, z, ls


def _both(kind, x, z, ls, g):
    xt, zt, lt = (torch.tensor(a, requires_grad=True) for a in (x, z, ls))
    kt = tkm.kernel_matrix(xt, zt, lt, kind)
    grads_t = torch.autograd.grad(kt, (xt, zt, lt), torch.tensor(g))
    fj = jax.jit(jk.KERNELS[kind])
    kj, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(z), jnp.asarray(ls))
    grads_j = vjp(jnp.asarray(g))
    return kt, grads_t, kj, grads_j


SHAPES = pytest.mark.parametrize(
    "n,m,d,batch,coincident",
    [(35, 35, 2, (2,), True), (300, 257, 7, (), False), (35, 1, 2, (6,), False),
     (20, 13, 8, (), False), (9, 11, 20, (3,), False)],
    ids=["fit-35x35x2", "300x257x7", "acq-6x35x1", "d8", "d20"],
)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize(
    "n,m,d,batch,coincident",
    [(35, 35, 2, (2,), True), (35, 1, 2, (6,), False), (9, 11, 20, (3,), False)],
    ids=["fit-35x35x2", "acq-6x35x1", "d20"],
)
def test_plain_matches_jax(kind, n, m, d, batch, coincident):
    x, z, ls = _inputs(n, m, d, batch, coincident=coincident)
    shape = batch + (n, n if coincident else m)
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    kt, grads_t, kj, grads_j = _both(kind, x, z, ls, g)
    assert kt.shape == kj.shape and kt.dtype == torch.float32
    # matern12 = exp(-sqrt(d2)) has unit slope in r at r = 0: the two
    # packages' float32 d2 at coincident points (~1e-7 apart) differ by
    # ~3e-4 after the sqrt; every other case is a rounding of a d-term sum
    atol = 1e-3 if (kind == "matern12" and coincident) else 1e-6
    np.testing.assert_allclose(kt.detach().numpy(), np.asarray(kj), rtol=1e-5, atol=atol)
    # gradients sum up to n or m terms of size O(max |grad|); at coincident
    # points matern12's 1/r derivative sees the same d2 rounding as above
    gatol = 1e-3 if (kind == "matern12" and coincident) else 1e-5
    for gt, gj in zip(grads_t, grads_j):
        scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=gatol * scale)
    assert all(torch.isfinite(gt).all() for gt in grads_t)


def _numpy_kernel(kind, x, z, ls):
    xs, zs = x / ls[..., None, :], z / ls[..., None, :]
    d2 = np.maximum(
        (xs**2).sum(-1)[..., :, None] + (zs**2).sum(-1)[..., None, :]
        - 2 * xs @ np.swapaxes(zs, -1, -2), 0.0)
    r = np.sqrt(d2)
    return {"rbf": np.exp(-0.5 * d2),
            "matern52": (1 + np.sqrt(5) * r + 5 / 3 * d2) * np.exp(-np.sqrt(5) * r),
            "matern32": (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r),
            "matern12": np.exp(-r)}[kind]


@pytest.mark.parametrize("kind", KINDS)
@SHAPES
def test_plain_float64_matches_numpy(kind, n, m, d, batch, coincident):
    # the JAX kernels accumulate x z^T in float32 even under x64
    # (`preferred_element_type`), so float64 is held to numpy instead
    x, z, ls = _inputs(n, m, d, batch, coincident=coincident, dtype=np.float64)
    xt, zt, lt = (torch.tensor(a, requires_grad=True) for a in (x, z, ls))
    kt = tkm.kernel_matrix(xt, zt, lt, kind)
    assert kt.dtype == torch.float64
    atol = 1e-7 if (kind == "matern12" and coincident) else 1e-12
    np.testing.assert_allclose(kt.detach().numpy(), _numpy_kernel(kind, x, z, ls),
                               rtol=1e-12, atol=atol)
    grads = torch.autograd.grad(kt.sum(), (xt, zt, lt))
    assert all(torch.isfinite(g).all() for g in grads)


def test_kernel_fn_routes_cpu_tensors_to_plain_version():
    x, z, ls = (torch.tensor(a) for a in _inputs(5, 4, 3))
    before = tkm.kernel_matrix_cuda.launches
    for kind in KINDS:
        out = tk.kernel_fn(kind)(x, z, ls)
        torch.testing.assert_close(out, tk.KERNELS[kind](x, z, ls), rtol=0, atol=0)
    assert tkm.kernel_matrix_cuda.launches == before
    with pytest.raises(ValueError):
        tk.kernel_fn("categorical")


def test_cuda_wrapper_refuses_cpu_tensors():
    x, z, ls = (torch.tensor(a) for a in _inputs(5, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tkm.kernel_matrix_cuda(x, z, ls, "rbf")


def test_batched_buffers():
    """The wrapper's batch layout: shared inputs get batch stride 0, batched
    ones a contiguous (B, ...) buffer (what the kernel indexes)."""
    x = torch.rand(35, 2)
    buf, stride = tkm._batched(x, (6,), (35, 2))
    assert stride == 0 and buf.shape == (35, 2)
    z = torch.rand(6, 1, 2).transpose(-1, -2).transpose(-1, -2)
    buf, stride = tkm._batched(z, (6,), (1, 2))
    assert stride == 2 and buf.shape == (6, 1, 2) and buf.is_contiguous()
    ls = torch.rand(1, 2)
    buf, stride = tkm._batched(ls, (4, 3), (2,))
    assert stride == 0 and buf.shape == (2,)
    ls = torch.rand(3, 2)
    buf, stride = tkm._batched(ls, (4, 3), (2,))
    assert stride == 2 and buf.shape == (4, 3, 2)
    np.testing.assert_array_equal(buf[2].numpy(), ls.numpy())
